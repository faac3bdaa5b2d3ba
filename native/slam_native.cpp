// Native runtime components for slam_tpu.
//
// The reference implements its whole runtime in C++; this build keeps
// the compute path in XLA but implements the runtime I/O natively too:
//
//  1. Telemetry publisher: the NetworkPlot ZMQ wire protocol
//     (reference src/backend/plotting/NetworkPlot.cpp — PAIR socket to
//     tcp://127.0.0.1:4242, multipart messages, one scalar per frame in
//     network byte order per the vendored zmqpp encoding,
//     libs/zmqpp/message.cpp:233-305). This build environment ships
//     libzmq.so.5 without headers, so the needed libzmq ABI is declared
//     here directly.
//  2. Map loader: the `lm/wp` text format parser
//     (reference src/backend/core.cpp:855-962), exposed over a C ABI.
//
// Built as libslam_native.so (tools/build_native.py); consumed from
// Python via ctypes (slam_tpu/runtime/native.py) with a pure-Python
// fallback when the library is unavailable.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <endian.h>
#include <string>
#include <vector>

// ---------------------------------------------------------------------------
// libzmq ABI (stable since libzmq 3.x; runtime links against libzmq.so.5)
// ---------------------------------------------------------------------------
extern "C" {
void *zmq_ctx_new(void);
int zmq_ctx_term(void *ctx);
void *zmq_socket(void *ctx, int type);
int zmq_close(void *s);
int zmq_connect(void *s, const char *addr);
int zmq_bind(void *s, const char *addr);
int zmq_send(void *s, const void *buf, size_t len, int flags);
}

static const int kZmqPair = 0;
static const int kSndMore = 2;

// ---------------------------------------------------------------------------
// Frame encoding (zmqpp network byte order)
// ---------------------------------------------------------------------------
static inline uint32_t enc_u32(uint32_t v) { return htobe32(v); }
static inline int32_t enc_i32(int32_t v) {
  return (int32_t)htobe32((uint32_t)v);
}
static inline uint32_t enc_f32(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return htobe32(u);
}
static inline uint64_t enc_f64(double v) {
  uint64_t u;
  memcpy(&u, &v, 8);
  return htobe64(u);
}

struct Telemetry {
  void *ctx = nullptr;
  void *sock = nullptr;
};

static int send_frame(Telemetry *t, const void *buf, size_t n, bool more) {
  return zmq_send(t->sock, buf, n, more ? kSndMore : 0) < 0 ? -1 : 0;
}

static int send_tag(Telemetry *t, const char *tag, bool more) {
  return send_frame(t, tag, strlen(tag), more);
}

static int send_f64(Telemetry *t, double v, bool more) {
  uint64_t u = enc_f64(v);
  return send_frame(t, &u, 8, more);
}

static int send_f32(Telemetry *t, float v, bool more) {
  uint32_t u = enc_f32(v);
  return send_frame(t, &u, 4, more);
}

static int send_u32(Telemetry *t, uint32_t v, bool more) {
  uint32_t u = enc_u32(v);
  return send_frame(t, &u, 4, more);
}

static int send_i32(Telemetry *t, int32_t v, bool more) {
  int32_t u = enc_i32(v);
  return send_frame(t, &u, 4, more);
}

extern "C" {

// -- lifecycle -------------------------------------------------------------
Telemetry *tele_connect(const char *endpoint) {
  Telemetry *t = new Telemetry();
  t->ctx = zmq_ctx_new();
  if (!t->ctx) { delete t; return nullptr; }
  t->sock = zmq_socket(t->ctx, kZmqPair);
  if (!t->sock || zmq_connect(t->sock, endpoint) != 0) {
    if (t->sock) zmq_close(t->sock);
    zmq_ctx_term(t->ctx);
    delete t;
    return nullptr;
  }
  return t;
}

void tele_close(Telemetry *t) {
  if (!t) return;
  zmq_close(t->sock);
  zmq_ctx_term(t->ctx);
  delete t;
}

// -- xs/ys array family (NetworkPlot::sendXYArrays) ------------------------
int tele_send_xy(Telemetry *t, const char *tag, const double *xs, int nx,
                 const double *ys, int ny) {
  if (send_tag(t, tag, true)) return -1;
  if (send_i32(t, nx, true)) return -1;
  for (int i = 0; i < nx; i++)
    if (send_f64(t, xs[i], true)) return -1;
  if (send_i32(t, ny, ny > 0)) return -1;
  for (int i = 0; i < ny; i++)
    if (send_f64(t, ys[i], i + 1 < ny)) return -1;
  return 0;
}

// -- float-matrix family (setLaserLines / setCovEllipse) -------------------
int tele_send_matrix(Telemetry *t, const char *tag, const float *data,
                     uint32_t rows, uint32_t cols, int idx,
                     int with_idx) {
  if (send_tag(t, tag, true)) return -1;
  if (send_u32(t, rows, true)) return -1;
  uint32_t n = rows * cols;
  if (send_u32(t, cols, n > 0 || with_idx)) return -1;
  for (uint32_t i = 0; i < n; i++)
    if (send_f32(t, data[i], i + 1 < n || with_idx)) return -1;
  if (with_idx && send_i32(t, idx, false)) return -1;
  return 0;
}

// -- fixed-layout messages -------------------------------------------------
int tele_send_doubles(Telemetry *t, const char *tag, const double *vals,
                      int n) {
  if (send_tag(t, tag, n > 0)) return -1;
  for (int i = 0; i < n; i++)
    if (send_f64(t, vals[i], i + 1 < n)) return -1;
  return 0;
}

int tele_send_car_size(Telemetry *t, double s, uint32_t id) {
  if (send_tag(t, "setCarSize", true)) return -1;
  if (send_f64(t, s, true)) return -1;
  return send_u32(t, id, false);
}

int tele_send_u32_msg(Telemetry *t, const char *tag, uint32_t v) {
  if (send_tag(t, tag, true)) return -1;
  return send_u32(t, v, false);
}

int tele_send_string(Telemetry *t, const char *tag, const char *s) {
  if (send_tag(t, tag, true)) return -1;
  return send_frame(t, s, strlen(s), false);
}

int tele_send_bare(Telemetry *t, const char *tag) {
  return send_tag(t, tag, false);
}

// ---------------------------------------------------------------------------
// Map loader (reference text .mat format, core.cpp:855-962)
// ---------------------------------------------------------------------------
// Parses `lm <rows> <cols>` / `wp <rows> <cols>` sections with '#'
// comments; returns 0 on success. Caller provides capacity; *n_lm /
// *n_wp receive counts; lm/wp receive interleaved x,y pairs.
int load_map_file(const char *path, double *lm, int lm_capacity,
                  int *n_lm, double *wp, int wp_capacity, int *n_wp) {
  FILE *fh = fopen(path, "r");
  if (!fh) return -1;
  *n_lm = 0;
  *n_wp = 0;
  char line[4096];
  int mode = 0;  // 0 none, 1 lm, 2 wp
  int remaining = 0, rows = 0;
  while (fgets(line, sizeof line, fh)) {
    char *p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '#' || *p == '\n' || *p == '\r' || *p == '\0') continue;
    if (remaining == 0) {
      char tag[8];
      int r, c;
      if (sscanf(p, "%7s %d %d", tag, &r, &c) != 3) { fclose(fh); return -2; }
      if (strcmp(tag, "lm") == 0) mode = 1;
      else if (strcmp(tag, "wp") == 0) mode = 2;
      else { fclose(fh); return -2; }
      rows = r;
      remaining = c;
      continue;
    }
    double x = 0, y = 0;
    if (rows >= 2) {
      if (sscanf(p, "%lf %lf", &x, &y) != 2) { fclose(fh); return -3; }
    } else {
      if (sscanf(p, "%lf", &x) != 1) { fclose(fh); return -3; }
    }
    if (mode == 1) {
      if (*n_lm >= lm_capacity) { fclose(fh); return -4; }
      lm[2 * (*n_lm)] = x;
      lm[2 * (*n_lm) + 1] = y;
      (*n_lm)++;
    } else if (mode == 2) {
      if (*n_wp >= wp_capacity) { fclose(fh); return -4; }
      wp[2 * (*n_wp)] = x;
      wp[2 * (*n_wp) + 1] = y;
      (*n_wp)++;
    }
    remaining--;
  }
  fclose(fh);
  return 0;
}

}  // extern "C"
