#!/usr/bin/env python3
"""Capture GOLDEN telemetry frames from the REAL reference encoder.

Round-1/2 validated the wire protocol self-vs-self (our Python and C++
publishers, both written from reading libs/zmqpp/message.cpp — they could
be wrong together). This tool closes that hole: it builds the reference
backend WITH its real NetworkPlot.cpp and the vendored zmqpp, linked
against the system libzmq (this image lacks zmq.h, so a faithful minimal
header for the libzmq 4.x ABI is generated below — declarations only; the
bytes on the wire come from the system library and the REFERENCE encoder,
libs/zmqpp/message.cpp:233-305), runs one short session against a capture
PAIR socket, and writes the raw multipart frames to
tests/data/golden_zmq_frames.bin.

Fixture format (little-endian):
  magic b'SLAMZMQ1'
  uint32 n_messages
  per message: uint32 n_frames; per frame: uint32 len, bytes

Consumed by tests/test_native.py (reference-encoder golden tests).

Usage: python tools/golden_frames.py --ref <reference checkout>
           [--out tests/data/golden_zmq_frames.bin] [--messages 400]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Minimal zmq.h for the libzmq 4.x C ABI (values are the stable wire/ABI
# constants from the public libzmq headers; this declares only what the
# vendored zmqpp 4.1.1 compiles against).
ZMQ_H = r"""
#ifndef __ZMQ_H_INCLUDED__
#define __ZMQ_H_INCLUDED__
#include <stddef.h>
#ifdef __cplusplus
extern "C" {
#endif
#define ZMQ_VERSION_MAJOR 4
#define ZMQ_VERSION_MINOR 1
#define ZMQ_VERSION_PATCH 8
#define ZMQ_MAKE_VERSION(a,b,c) ((a)*10000 + (b)*100 + (c))
#define ZMQ_VERSION \
    ZMQ_MAKE_VERSION(ZMQ_VERSION_MAJOR, ZMQ_VERSION_MINOR, ZMQ_VERSION_PATCH)

void zmq_version (int *major, int *minor, int *patch);
int zmq_errno (void);
const char *zmq_strerror (int errnum);

/* Contexts */
void *zmq_ctx_new (void);
int zmq_ctx_term (void *context);
int zmq_ctx_destroy (void *context);
int zmq_ctx_set (void *context, int option, int optval);
int zmq_ctx_get (void *context, int option);
void *zmq_init (int io_threads);
int zmq_term (void *context);
#define ZMQ_IO_THREADS 1
#define ZMQ_MAX_SOCKETS 2
#define ZMQ_SOCKET_LIMIT 3
#define ZMQ_THREAD_PRIORITY 3
#define ZMQ_THREAD_SCHED_POLICY 4
#define ZMQ_IO_THREADS_DFLT 1
#define ZMQ_MAX_SOCKETS_DFLT 1023

/* Messages */
typedef struct zmq_msg_t { unsigned char _ [64]; } zmq_msg_t;
typedef void (zmq_free_fn) (void *data, void *hint);
int zmq_msg_init (zmq_msg_t *msg);
int zmq_msg_init_size (zmq_msg_t *msg, size_t size);
int zmq_msg_init_data (zmq_msg_t *msg, void *data, size_t size,
                       zmq_free_fn *ffn, void *hint);
int zmq_msg_send (zmq_msg_t *msg, void *s, int flags);
int zmq_msg_recv (zmq_msg_t *msg, void *s, int flags);
int zmq_msg_close (zmq_msg_t *msg);
int zmq_msg_move (zmq_msg_t *dest, zmq_msg_t *src);
int zmq_msg_copy (zmq_msg_t *dest, zmq_msg_t *src);
void *zmq_msg_data (zmq_msg_t *msg);
size_t zmq_msg_size (zmq_msg_t *msg);
int zmq_msg_more (zmq_msg_t *msg);
int zmq_msg_get (zmq_msg_t *msg, int property);
int zmq_msg_set (zmq_msg_t *msg, int property, int optval);
const char *zmq_msg_gets (zmq_msg_t *msg, const char *property);

/* Sockets */
void *zmq_socket (void *, int type);
int zmq_close (void *s);
int zmq_setsockopt (void *s, int option, const void *optval,
                    size_t optvallen);
int zmq_getsockopt (void *s, int option, void *optval, size_t *optvallen);
int zmq_bind (void *s, const char *addr);
int zmq_connect (void *s, const char *addr);
int zmq_unbind (void *s, const char *addr);
int zmq_disconnect (void *s, const char *addr);
int zmq_send (void *s, const void *buf, size_t len, int flags);
int zmq_send_const (void *s, const void *buf, size_t len, int flags);
int zmq_recv (void *s, void *buf, size_t len, int flags);
int zmq_sendmsg (void *s, zmq_msg_t *msg, int flags);
int zmq_recvmsg (void *s, zmq_msg_t *msg, int flags);
int zmq_socket_monitor (void *s, const char *addr, int events);

#define ZMQ_PAIR 0
#define ZMQ_PUB 1
#define ZMQ_SUB 2
#define ZMQ_REQ 3
#define ZMQ_REP 4
#define ZMQ_DEALER 5
#define ZMQ_ROUTER 6
#define ZMQ_PULL 7
#define ZMQ_PUSH 8
#define ZMQ_XPUB 9
#define ZMQ_XSUB 10
#define ZMQ_STREAM 11
#define ZMQ_XREQ ZMQ_DEALER
#define ZMQ_XREP ZMQ_ROUTER

#define ZMQ_AFFINITY 4
#define ZMQ_IDENTITY 5
#define ZMQ_SUBSCRIBE 6
#define ZMQ_UNSUBSCRIBE 7
#define ZMQ_RATE 8
#define ZMQ_RECOVERY_IVL 9
#define ZMQ_SNDBUF 11
#define ZMQ_RCVBUF 12
#define ZMQ_RCVMORE 13
#define ZMQ_FD 14
#define ZMQ_EVENTS 15
#define ZMQ_TYPE 16
#define ZMQ_LINGER 17
#define ZMQ_RECONNECT_IVL 18
#define ZMQ_BACKLOG 19
#define ZMQ_RECONNECT_IVL_MAX 21
#define ZMQ_MAXMSGSIZE 22
#define ZMQ_SNDHWM 23
#define ZMQ_RCVHWM 24
#define ZMQ_MULTICAST_HOPS 25
#define ZMQ_RCVTIMEO 27
#define ZMQ_SNDTIMEO 28
#define ZMQ_LAST_ENDPOINT 32
#define ZMQ_ROUTER_MANDATORY 33
#define ZMQ_TCP_KEEPALIVE 34
#define ZMQ_TCP_KEEPALIVE_CNT 35
#define ZMQ_TCP_KEEPALIVE_IDLE 36
#define ZMQ_TCP_KEEPALIVE_INTVL 37
#define ZMQ_TCP_ACCEPT_FILTER 38
#define ZMQ_IMMEDIATE 39
#define ZMQ_XPUB_VERBOSE 40
#define ZMQ_ROUTER_RAW 41
#define ZMQ_IPV6 42
#define ZMQ_MECHANISM 43
#define ZMQ_PLAIN_SERVER 44
#define ZMQ_PLAIN_USERNAME 45
#define ZMQ_PLAIN_PASSWORD 46
#define ZMQ_CURVE_SERVER 47
#define ZMQ_CURVE_PUBLICKEY 48
#define ZMQ_CURVE_SECRETKEY 49
#define ZMQ_CURVE_SERVERKEY 50
#define ZMQ_PROBE_ROUTER 51
#define ZMQ_REQ_CORRELATE 52
#define ZMQ_REQ_RELAXED 53
#define ZMQ_CONFLATE 54
#define ZMQ_ZAP_DOMAIN 55
#define ZMQ_ROUTER_HANDOVER 56
#define ZMQ_TOS 57
#define ZMQ_CONNECT_RID 61
#define ZMQ_HANDSHAKE_IVL 66
#define ZMQ_IPV4ONLY 31
#define ZMQ_DELAY_ATTACH_ON_CONNECT ZMQ_IMMEDIATE
#define ZMQ_IPC_FILTER_PID 58
#define ZMQ_IPC_FILTER_UID 59
#define ZMQ_IPC_FILTER_GID 60

#define ZMQ_NULL 0
#define ZMQ_PLAIN 1
#define ZMQ_CURVE 2

#define ZMQ_MORE 1
#define ZMQ_DONTWAIT 1
#define ZMQ_SNDMORE 2
#define ZMQ_NOBLOCK ZMQ_DONTWAIT

#define ZMQ_EVENT_CONNECTED 0x0001
#define ZMQ_EVENT_CONNECT_DELAYED 0x0002
#define ZMQ_EVENT_CONNECT_RETRIED 0x0004
#define ZMQ_EVENT_LISTENING 0x0008
#define ZMQ_EVENT_BIND_FAILED 0x0010
#define ZMQ_EVENT_ACCEPTED 0x0020
#define ZMQ_EVENT_ACCEPT_FAILED 0x0040
#define ZMQ_EVENT_CLOSED 0x0080
#define ZMQ_EVENT_CLOSE_FAILED 0x0100
#define ZMQ_EVENT_DISCONNECTED 0x0200
#define ZMQ_EVENT_MONITOR_STOPPED 0x0400
#define ZMQ_EVENT_ALL 0xFFFF

/* Polling */
typedef struct zmq_pollitem_t {
    void *socket;
    int fd;
    short events;
    short revents;
} zmq_pollitem_t;
#define ZMQ_POLLIN 1
#define ZMQ_POLLOUT 2
#define ZMQ_POLLERR 4
#define ZMQ_POLLPRI 8
#define ZMQ_POLLITEMS_DFLT 16
int zmq_poll (zmq_pollitem_t *items, int nitems, long timeout);

int zmq_proxy (void *frontend, void *backend, void *capture);
int zmq_device (int type, void *frontend, void *backend);
#define ZMQ_STREAMER 1
#define ZMQ_FORWARDER 2
#define ZMQ_QUEUE 3

/* Security */
char *zmq_z85_encode (char *dest, const unsigned char *data, size_t size);
unsigned char *zmq_z85_decode (unsigned char *dest, const char *string);
int zmq_curve_keypair (char *z85_public_key, char *z85_secret_key);

#ifdef __cplusplus
}
#endif
#endif
"""


def build_with_real_telemetry(ref: str, workdir: str) -> str:
    """Build slam-backend with the REAL NetworkPlot + vendored zmqpp,
    linked against the system libzmq.so.5 via the generated header."""
    dst = os.path.join(workdir, "ref")
    shutil.copytree(ref, dst)
    with open(os.path.join(dst, "libs/zmqpp/zmq.h"), "w") as fh:
        fh.write(ZMQ_H)

    def patch(path, pattern, repl):
        p = os.path.join(dst, path)
        src = open(p).read()
        open(p, "w").write(re.sub(pattern, repl, src, flags=re.M | re.S))

    # Link the system libzmq directly (no pkg-config file, no headers).
    patch("libs/zmqpp/CMakeLists.txt",
          r"else\(\).*endif\(\)",
          "else()\n"
          "    target_link_libraries(zmqpp PUBLIC "
          "/lib/x86_64-linux-gnu/libzmq.so.5)\nendif()")
    patch("CMakeLists.txt", r'option\(BUILD_GUI "build-gui" ON\)',
          'option(BUILD_GUI "build-gui" OFF)')
    # Vestigial wait() in wrapper destructors (SURVEY.md §2.2 note).
    for f in ("ekfslamwrapper", "fastslam1wrapper", "fastslam2wrapper"):
        patch(f"src/backend/wrappers/{f}.cpp", r"^\s*wait\(\);$", "")

    bld = os.path.join(dst, "build")
    os.makedirs(bld)
    subprocess.run(["cmake", "..", "-DCMAKE_BUILD_TYPE=Release",
                    "-G", "Ninja"], cwd=bld, check=True,
                   capture_output=True)
    subprocess.run(["ninja", "slam-backend"], cwd=bld, check=True,
                   capture_output=True)
    return os.path.join(bld, "src/backend/slam-backend")


def capture(binary: str, data_dir: str, n_messages: int,
            mapname="example_loop1", method="FASTSLAM1", seed=1):
    sys.path.insert(0, REPO)
    from slam_tpu.runtime.telemetry import ZmqPairSocket

    sock = ZmqPairSocket("tcp://*:4242", bind=True)
    proc = subprocess.Popen(
        [binary, "-m", f"{data_dir}/{mapname}.mat", "-method", method,
         "-mode", "waypoints", "-SWITCH_SEED_RANDOM", str(seed)],
        cwd=os.path.dirname(os.path.dirname(data_dir)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    messages = []
    deadline = time.time() + 120
    try:
        while len(messages) < n_messages and time.time() < deadline:
            frames = sock.recv_multipart(dontwait=True)
            if frames is None:
                if proc.poll() is not None:
                    break
                time.sleep(0.005)
                continue
            messages.append(frames)
    finally:
        if proc.poll() is None:
            proc.kill()       # exact PID of the process we started
            proc.wait()
        sock.close()
    return messages


def write_fixture(messages, out_path: str):
    with open(out_path, "wb") as fh:
        fh.write(b"SLAMZMQ1")
        fh.write(struct.pack("<I", len(messages)))
        for frames in messages:
            fh.write(struct.pack("<I", len(frames)))
            for fr in frames:
                fh.write(struct.pack("<I", len(fr)))
                fh.write(fr)


def read_fixture(path: str):
    with open(path, "rb") as fh:
        assert fh.read(8) == b"SLAMZMQ1", "bad fixture magic"
        (n_msg,) = struct.unpack("<I", fh.read(4))
        messages = []
        for _ in range(n_msg):
            (n_fr,) = struct.unpack("<I", fh.read(4))
            frames = []
            for _ in range(n_fr):
                (ln,) = struct.unpack("<I", fh.read(4))
                frames.append(fh.read(ln))
            messages.append(frames)
        return messages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True,
                    help="checkout of the reference source")
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "data", "golden_zmq_frames.bin"))
    ap.add_argument("--messages", type=int, default=400)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as wd:
        binary = build_with_real_telemetry(args.ref, wd)
        print(f"built {binary}", file=sys.stderr)
        data_dir = os.path.join(wd, "ref", "data")
        # FASTSLAM1 covers the particle-family tags; EKF1 adds the
        # covariance-ellipse family (drawCovarianceEllipseLines).
        messages = capture(binary, data_dir, args.messages,
                           method="FASTSLAM1")
        messages += capture(binary, data_dir, args.messages,
                            method="EKF1")
    tags = {}
    for frames in messages:
        tags[frames[0].decode("ascii", "replace")] = \
            tags.get(frames[0].decode("ascii", "replace"), 0) + 1
    print(f"captured {len(messages)} messages; tags: {tags}",
          file=sys.stderr)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    write_fixture(messages, args.out)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
