"""Map I/O: landmark + waypoint maps.

Reads the reference's text ``.mat`` format (src/backend/core.cpp:855-962):

    # comment
    lm <rows> <cols>
    <cols lines of rows floats>     # one landmark per LINE (column-major file)
    wp <rows> <cols>
    <cols lines of rows floats>

In the reference, data is stored transposed (a 2xN Eigen matrix filled one
column per file line). Here maps are plain row-major numpy arrays:
``landmarks [N, 2]`` and ``waypoints [W, 2]``.

Also provides the seeded reference-shaped example maps committed under
``data/`` (``reference_like_map``, ``load_reference_like``) and
``synthetic_map`` for the large-scale benchmark configs (10k-landmark
map, BASELINE.json config #5) which has no reference counterpart.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SlamMap:
    landmarks: np.ndarray  # [N, 2] float32
    waypoints: np.ndarray  # [W, 2] float32

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])

    @property
    def n_waypoints(self) -> int:
        return int(self.waypoints.shape[0])

    def extent(self):
        """(xmin, xmax, ymin, ymax) over landmarks+waypoints, padded 5%
        (reference plot range logic, slamwrapper.cpp:141-172)."""
        pts = np.concatenate([self.landmarks, self.waypoints], axis=0)
        xmin, ymin = pts.min(axis=0)
        xmax, ymax = pts.max(axis=0)
        dx, dy = xmax - xmin, ymax - ymin
        return (xmin - 0.05 * dx, xmax + 0.05 * dx,
                ymin - 0.05 * dy, ymax + 0.05 * dy)


def read_map_file(path: str) -> SlamMap:
    """Parse a reference-format map file into a SlamMap.

    Mirrors readInputFile behavior (core.cpp:855-962): ``#`` comment lines
    and blank lines skipped; ``lm``/``wp`` headers give (rows, cols); the
    following ``cols`` non-blank lines each carry ``rows`` floats.
    """
    landmarks = None
    waypoints = None
    with open(path, "r") as fh:
        lines = [ln.strip() for ln in fh]
    # Iterate with an explicit cursor so section bodies can consume lines.
    i = 0

    def next_data_line():
        nonlocal i
        while i < len(lines):
            ln = lines[i]
            i += 1
            if not ln or ln.startswith("#"):
                continue
            return ln
        raise ValueError(f"{path}: unexpected EOF inside section")

    while True:
        # find next header
        header = None
        while i < len(lines):
            ln = lines[i]
            i += 1
            if not ln or ln.startswith("#"):
                continue
            header = ln
            break
        if header is None:
            break
        tokens = header.split()
        if tokens[0] not in ("lm", "wp") or len(tokens) != 3:
            raise ValueError(f"{path}: bad section header: {header!r}")
        rows, cols = int(float(tokens[1])), int(float(tokens[2]))
        data = np.empty((cols, rows), dtype=np.float32)
        for c in range(cols):
            vals = next_data_line().split()
            if len(vals) < rows:
                raise ValueError(f"{path}: short data line in {tokens[0]}")
            data[c] = [float(v) for v in vals[:rows]]
        if tokens[0] == "lm":
            landmarks = data
        else:
            waypoints = data

    if landmarks is None or waypoints is None:
        raise ValueError(f"{path}: missing lm or wp section")
    return SlamMap(landmarks=landmarks, waypoints=waypoints)


def write_map_file(path: str, slam_map: SlamMap) -> None:
    """Write a SlamMap in the reference text format (round-trips with
    read_map_file; used by tests and synthetic-map generation)."""
    with open(path, "w") as fh:
        fh.write("#type columns rows\n")
        fh.write(f"lm 2 {slam_map.n_landmarks}\n")
        for x, y in slam_map.landmarks:
            fh.write(f"{x:.6f} {y:.6f}\n")
        fh.write(f"\nwp 2 {slam_map.n_waypoints}\n")
        for x, y in slam_map.waypoints:
            fh.write(f"{x:.6f} {y:.6f}\n")


# Reference-shaped workloads. The reference ships four example maps
# (BASELINE.md:21-27) that this repository does not carry. These specs
# keep their shapes and parameters: landmark and waypoint counts, the
# .ini parameters, and the loop length per lap (the reference backend's
# run length in ref_baseline.json x DT_CONTROLS x V / NUMBER_LOOPS).
# The geometry itself is generated from the seed by ``reference_like_map``.
_COMMON_INI = {
    "DT_CONTROLS": 0.025, "DT_OBSERVE": 0.2, "NUMBER_LOOPS": 2,
    "sigmaV": 0.3, "sigmaG": math.radians(3.0), "sigmaR": 0.1,
    "sigmaB": math.radians(1.0), "sigmaT": math.radians(1.0),
    "NPARTICLES": 100, "NEFFECTIVE": 75,
}
_LOOP_INI = {"Vtrue": 1.0, "WHEELBASE": 1.0, "MAX_RANGE": 10.0,
             "MAXG": math.pi, "SWITCH_HEADING_KNOWN": 1}
_WEBMAP_INI = {"Vtrue": 3.0, "WHEELBASE": 4.0, "MAX_RANGE": 60.0,
               "MAXG": math.radians(30.0), "SWITCH_HEADING_KNOWN": 0}

REFERENCE_LIKE = {
    "loop1_like": dict(n_landmarks=22, n_waypoints=33, loop_length=172.8,
                       shape_of="example_loop1", ini=_LOOP_INI, seed=1),
    "loop2_like": dict(n_landmarks=25, n_waypoints=30, loop_length=158.9,
                       shape_of="example_loop2", ini=_LOOP_INI, seed=2),
    "loop902_like": dict(n_landmarks=117, n_waypoints=24,
                         loop_length=430.2, shape_of="example_loop902",
                         ini=_LOOP_INI, seed=902),
    "webmap_like": dict(n_landmarks=35, n_waypoints=17, loop_length=651.8,
                        shape_of="example_webmap", ini=_WEBMAP_INI,
                        seed=4),
}


def reference_like_map(name: str) -> SlamMap:
    """The seeded map ``REFERENCE_LIKE[name]``: waypoints on a wobbly
    closed loop of the spec's length, traversed counter-clockwise from
    the origin (the vehicle's start pose, heading +x, sits halfway
    along the closing segment), and landmarks scattered on both sides
    of the path at 20-80 % of the sensor range."""
    spec = REFERENCE_LIKE[name]
    rng = np.random.default_rng(spec["seed"])
    n_wp = spec["n_waypoints"]
    a1, a2 = rng.uniform(0.08, 0.18, 2)
    f1, f2 = rng.uniform(0.0, 2 * np.pi, 2)
    theta = np.linspace(0.0, 2 * np.pi, n_wp, endpoint=False)
    r = 1.0 + a1 * np.sin(2 * theta + f1) + a2 * np.sin(3 * theta + f2)
    wp = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    seg = np.roll(wp, -1, axis=0) - wp
    wp *= spec["loop_length"] / np.linalg.norm(seg, axis=1).sum()

    # Frame: origin at the midpoint of the closing segment wp[-1]->wp[0],
    # which points along +x.
    start = 0.5 * (wp[-1] + wp[0])
    d = wp[0] - wp[-1]
    c, s = d / np.linalg.norm(d)
    rot = np.array([[c, s], [-s, c]])
    wp = (wp - start) @ rot.T

    # Landmarks: uniform arc positions along the closed path, offset
    # along the path normal to either side.
    pts = np.vstack([wp, wp[:1]])
    seg = np.diff(pts, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    arc = rng.uniform(0.0, cum[-1], spec["n_landmarks"])
    i = np.searchsorted(cum, arc, side="right") - 1
    t = (arc - cum[i]) / seg_len[i]
    base = pts[i] + t[:, None] * seg[i]
    tangent = seg[i] / seg_len[i][:, None]
    normal = np.stack([-tangent[:, 1], tangent[:, 0]], axis=1)
    side = rng.choice([-1.0, 1.0], spec["n_landmarks"])
    offset = side * rng.uniform(0.2, 0.8, spec["n_landmarks"]) \
        * spec["ini"]["MAX_RANGE"]
    lm = base + offset[:, None] * normal
    return SlamMap(landmarks=lm.astype(np.float32),
                   waypoints=wp.astype(np.float32))


DATA_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__),
                                         os.pardir, "data"))


def load_reference_like(name: str):
    """(SlamConfig, SlamMap) of the committed ``data/<name>.{ini,mat}``,
    e.g. ``load_reference_like("webmap_like")``."""
    from slam_tpu.config import SlamConfig

    base = os.path.join(DATA_DIR, name)
    return SlamConfig.from_ini(base + ".ini"), read_map_file(base + ".mat")


def write_reference_like(name: str, directory: str) -> tuple[str, str]:
    """Write ``<directory>/<name>.mat`` and ``<name>.ini``; returns the
    two paths."""
    spec = REFERENCE_LIKE[name]
    mat = os.path.join(directory, f"{name}.mat")
    ini = os.path.join(directory, f"{name}.ini")
    write_map_file(mat, reference_like_map(name))
    with open(ini, "w") as fh:
        fh.write(f"# Generated by tools/make_maps.py (seed {spec['seed']}).\n"
                 f"# Shaped like the reference's {spec['shape_of']}; "
                 f"not the reference's own map.\n")
        for key, val in {**spec["ini"], **_COMMON_INI}.items():
            fh.write(f"{key} = {val!r}\n")
    return mat, ini


def synthetic_map(n_landmarks: int, n_waypoints: int = 32,
                  radius: float = 200.0, seed: int = 0) -> SlamMap:
    """Generate a large synthetic map: waypoints on a loop, landmarks
    scattered around the loop corridor. Supports the 10k-landmark
    multi-device benchmark config (BASELINE.json config #5)."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2 * np.pi, n_waypoints, endpoint=False)
    # wobbly loop so steering stays non-trivial
    r_wp = radius * (1.0 + 0.15 * np.sin(3 * theta))
    waypoints = np.stack([r_wp * np.cos(theta), r_wp * np.sin(theta)],
                         axis=1).astype(np.float32)
    # landmarks in an annulus around the loop
    ang = rng.uniform(0.0, 2 * np.pi, n_landmarks)
    rad = radius * (1.0 + rng.uniform(-0.4, 0.4, n_landmarks))
    landmarks = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                         axis=1).astype(np.float32)
    return SlamMap(landmarks=landmarks, waypoints=waypoints)
