"""Telemetry wire-protocol tests: publisher frames decode exactly as the
stock slam-gui Controller would (Controller.cpp:35-227 dispatch; zmqpp
network-byte-order scalar encoding)."""

import struct
import threading

import numpy as np
import pytest

try:
    from slam_tpu.runtime.telemetry import (
        LibZmq,
        NetworkPlot,
        ZmqPairSocket,
        decode_message,
    )
    LibZmq()
    HAVE_ZMQ = True
except OSError:
    HAVE_ZMQ = False

pytestmark = pytest.mark.skipif(not HAVE_ZMQ,
                                reason="libzmq not available")

ENDPOINT = "tcp://127.0.0.1:45454"


@pytest.fixture
def pair():
    server = ZmqPairSocket(ENDPOINT, bind=True)
    plot = NetworkPlot(socket=ZmqPairSocket(ENDPOINT, bind=False))
    yield server, plot
    plot.close()
    server.close()


def test_scalar_messages_roundtrip(pair):
    server, plot = pair
    plot.add_true_position(1.5, -2.25)
    tag, vals = decode_message(server.recv_multipart())
    assert tag == "addTruePosition"
    assert vals == [1.5, -2.25]

    plot.set_car_estimated_position(0.5, 0.25, 3.0)
    tag, vals = decode_message(server.recv_multipart())
    assert tag == "setCarEstimatedPosition"
    assert vals == [0.5, 0.25, 3.0]

    plot.loop_time(12345)
    tag, vals = decode_message(server.recv_multipart())
    assert tag == "loopTime" and vals == [12345]


def test_xy_array_encoding(pair):
    """sendXYArrays layout: i32 n, n doubles, i32 m, m doubles — every
    scalar its own network-order frame (NetworkPlot.cpp:22-34)."""
    server, plot = pair
    plot.set_landmarks([1.0, 2.0], [3.0, 4.0, 5.0])
    frames = server.recv_multipart()
    assert frames[0] == b"setLandmarks"
    assert struct.unpack(">i", frames[1])[0] == 2
    assert struct.unpack(">d", frames[2])[0] == 1.0
    assert struct.unpack(">d", frames[3])[0] == 2.0
    assert struct.unpack(">i", frames[4])[0] == 3
    assert [struct.unpack(">d", f)[0] for f in frames[5:8]] == [3., 4., 5.]


def test_matrix_encoding(pair):
    """Float-matrix layout: u32 rows, u32 cols, row-major f32 frames
    (NetworkPlot.cpp:68-98); setCovEllipse appends i32 idx."""
    server, plot = pair
    mat = np.arange(8, dtype=np.float32).reshape(4, 2)
    plot.set_cov_ellipse(mat, idx=7)
    frames = server.recv_multipart()
    assert frames[0] == b"setCovEllipse"
    assert struct.unpack(">I", frames[1])[0] == 4
    assert struct.unpack(">I", frames[2])[0] == 2
    vals = [struct.unpack(">f", f)[0] for f in frames[3:11]]
    assert vals == list(range(8))
    assert struct.unpack(">i", frames[11])[0] == 7


def test_control_messages(pair):
    server, plot = pair
    plot.plot()
    assert server.recv_multipart() == [b"plot"]
    plot.set_simulation_name("hello")
    assert server.recv_multipart() == [b"setSimulationName", b"hello"]
    plot.end_plot()
    assert server.recv_multipart() == [b"endPlot"]


def test_streaming_run_emits_protocol(tmp_path, workload):
    """A short EKF streaming run against a local PAIR receiver produces
    the expected message sequence (setup + per-superstep emission)."""
    from slam_tpu.runtime import Runner

    server = ZmqPairSocket("tcp://127.0.0.1:45455", bind=True)
    received = []

    def drain():
        while True:
            frames = server.recv_multipart()
            received.append(frames[0].decode())
            if frames[0] == b"endPlot":
                return

    t = threading.Thread(target=drain, daemon=True)
    t.start()

    cfg, slam_map = workload("loop1_like")
    runner = Runner(cfg, slam_map, "EKF1")
    plot = NetworkPlot(socket=ZmqPairSocket("tcp://127.0.0.1:45455",
                                            bind=False))
    result = runner.run_streaming(seed=1, n_ticks=160, plot=plot)
    plot.close()
    t.join(timeout=30)
    server.close()

    assert "setPlotRange" in received
    assert "setLandmarks" in received and "setWaypoints" in received
    assert received.count("plot") == len(result.true_pose)
    assert received.count("addTruePosition") == len(result.true_pose)
    assert "setLaserLines" in received
    assert "covEllipseAdd" in received      # EKF ellipse path
    assert received[-1] == "endPlot"


class StrictController:
    """Byte-for-byte replay of the stock GUI's dispatcher
    (Controller.cpp:35-227): every zmqpp ``>>`` read is one frame with
    a fixed width, every frame must be consumed, setCovEllipse indices
    must fit the capacity announced by the latest covEllipseAdd (the
    ellipse-count protocol, Controller.cpp:217-222), and each plot()
    turn must carry exactly one true/estimated pose quadruple — the
    preconditions DataGatherer::nextTurn relies on."""

    SCALARS = {
        "addTruePosition": ("d", "d"),
        "addEstimatedPosition": ("d", "d"),
        "setCarTruePosition": ("d", "d", "d"),
        "setCarEstimatedPosition": ("d", "d", "d"),
        "setPlotRange": ("d", "d", "d", "d"),
        "setCarSize": ("d", "I"),
        "setCurrentIteration": ("I",),
        "covEllipseAdd": ("I",),
        "loopTime": ("I",),
    }
    WIDTH = {"d": 8, "I": 4, "f": 4}

    def __init__(self):
        self.counts = {}
        self.ellipse_capacity = None
        self.turn = {}
        self.n_turns = 0
        self.setup_seen = set()
        self.done = False

    def _scalar(self, frame, fmt):
        assert len(frame) == self.WIDTH[fmt], (len(frame), fmt)
        return struct.unpack("!" + fmt, frame)[0]

    def _xy(self, frames):
        it = iter(frames)
        xs = self._scalar(next(it), "I")
        for _ in range(xs):
            self._scalar(next(it), "d")
        ys = self._scalar(next(it), "I")
        for _ in range(ys):
            self._scalar(next(it), "d")
        assert next(it, None) is None, "trailing frames"
        assert xs == ys

    def _matrix(self, frames, trailing_idx=False):
        it = iter(frames)
        rows = self._scalar(next(it), "I")
        cols = self._scalar(next(it), "I")
        for _ in range(rows * cols):
            self._scalar(next(it), "f")
        idx = self._scalar(next(it), "I") if trailing_idx else None
        assert next(it, None) is None, "trailing frames"
        return rows, cols, idx

    def feed(self, frames):
        assert not self.done, "message after endPlot"
        tag = frames[0].decode()
        body = frames[1:]
        self.counts[tag] = self.counts.get(tag, 0) + 1
        if tag in ("setLandmarks", "setWaypoints", "setParticles",
                   "setFeatureParticles"):
            self._xy(body)
            self.setup_seen.add(tag)
        elif tag == "setLaserLines":
            rows, cols, _ = self._matrix(body)
            assert rows == 4          # x1,y1,x2,y2 per beam
        elif tag == "setCovEllipse":
            rows, cols, idx = self._matrix(body, trailing_idx=True)
            assert rows == 2          # x/y polyline
            assert self.ellipse_capacity is not None, \
                "setCovEllipse before covEllipseAdd"
            assert idx < self.ellipse_capacity, (idx,
                                                 self.ellipse_capacity)
        elif tag == "covEllipseAdd":
            self.ellipse_capacity = self._scalar(body[0], "I")
            assert len(body) == 1
        elif tag in self.SCALARS:
            fmts = self.SCALARS[tag]
            assert len(body) == len(fmts), (tag, len(body))
            for fr, f in zip(body, fmts):
                self._scalar(fr, f)
            if tag in ("addTruePosition", "addEstimatedPosition",
                       "setCarTruePosition", "setCarEstimatedPosition"):
                self.turn[tag] = self.turn.get(tag, 0) + 1
            if tag == "setPlotRange":
                self.setup_seen.add(tag)
        elif tag == "setSimulationName":
            assert len(body) == 1 and len(body[0]) > 0
            self.setup_seen.add(tag)
        elif tag == "plot":
            assert not body
            # One pose quadruple per turn — what nextTurn() records.
            assert self.turn == {
                "addTruePosition": 1, "addEstimatedPosition": 1,
                "setCarTruePosition": 1, "setCarEstimatedPosition": 1,
            }, self.turn
            self.turn = {}
            self.n_turns += 1
        elif tag == "clear":
            assert not body
        elif tag == "endPlot":
            assert not body
            self.done = True
        else:
            raise AssertionError(f"unknown tag {tag!r}")


@pytest.mark.parametrize("method,needs", [
    ("EKF1", ("covEllipseAdd", "setCovEllipse")),
    ("FASTSLAM2", ("setParticles", "setFeatureParticles")),
])
def test_streaming_run_strict_controller(method, needs, workload):
    """A LIVE -plot session must satisfy the stock GUI Controller's
    dispatch preconditions end-to-end (receiver-side validation of the
    live stream, not re-encoded fixtures)."""
    from slam_tpu.runtime import Runner

    port = 45460 + (0 if method == "EKF1" else 1)
    ep = f"tcp://127.0.0.1:{port}"
    server = ZmqPairSocket(ep, bind=True)
    ctrl = StrictController()
    errors = []

    def drain():
        while not ctrl.done:
            try:
                ctrl.feed(server.recv_multipart())
            except Exception as e:          # surface in main thread
                errors.append(e)
                return

    t = threading.Thread(target=drain, daemon=True)
    t.start()

    cfg, slam_map = workload("loop1_like")
    runner = Runner(cfg, slam_map, method,
                    n_particles=50 if method != "EKF1" else None)
    plot = NetworkPlot(socket=ZmqPairSocket(ep, bind=False))
    result = runner.run_streaming(seed=1, n_ticks=160, plot=plot)
    plot.close()
    t.join(timeout=30)
    server.close()
    assert not errors, errors[0]
    assert ctrl.done
    assert ctrl.n_turns == len(result.true_pose)
    for tag in ("setPlotRange", "setSimulationName", "setLandmarks",
                "setWaypoints"):
        assert tag in ctrl.setup_seen
    for tag in needs:
        assert ctrl.counts.get(tag, 0) > 0, tag
