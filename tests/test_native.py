"""Native (C++) runtime components: golden equivalence with the Python
implementations — telemetry frames byte-for-byte, map loader array-equal."""

import numpy as np
import pytest

from slam_tpu.maps import read_map_file

try:
    from slam_tpu.runtime.native import (
        NativeNetworkPlot,
        load_map_native,
        native_available,
    )
    HAVE = native_available()
except Exception:
    HAVE = False

pytestmark = pytest.mark.skipif(not HAVE,
                                reason="native lib not buildable here")


def test_native_map_loader_matches_python(map_path):
    for name in ("loop1_like", "loop2_like", "loop902_like",
                 "webmap_like"):
        path = map_path(name)
        lm, wp = load_map_native(path)
        ref = read_map_file(path)
        np.testing.assert_allclose(lm, ref.landmarks, atol=1e-6)
        np.testing.assert_allclose(wp, ref.waypoints, atol=1e-6)


def test_native_telemetry_frames_match_python():
    """Every message type produced by the C++ publisher is byte-identical
    to the Python publisher's frames."""
    from slam_tpu.runtime.telemetry import NetworkPlot, ZmqPairSocket

    ep = "tcp://127.0.0.1:45457"
    server = ZmqPairSocket(ep, bind=True)
    native = NativeNetworkPlot(ep)

    ep2 = "tcp://127.0.0.1:45458"
    server2 = ZmqPairSocket(ep2, bind=True)
    py = NetworkPlot(socket=ZmqPairSocket(ep2, bind=False))

    mat = np.arange(12, dtype=np.float32).reshape(4, 3)

    def emit(p):
        p.set_landmarks([1.0, 2.5], [3.0, -4.0])
        p.set_waypoints([0.5], [0.25, 9.0])
        p.add_true_position(1.0, 2.0)
        p.add_estimated_position(-1.0, 0.125)
        p.set_car_true_position(1, 2, 3)
        p.set_car_estimated_position(4, 5, 6)
        p.set_car_size(2.5, 1)
        p.set_plot_range(-1, 1, -2, 2)
        p.set_laser_lines(mat)
        p.set_cov_ellipse(mat, 3)
        p.set_particles([7.0], [8.0])
        p.set_feature_particles([], [])
        p.cov_ellipse_add(5)
        p.loop_time(777)
        p.set_simulation_name("sim")
        p.clear()
        p.plot()
        p.end_plot()

    emit(native)
    emit(py)

    for _ in range(18):
        f_native = server.recv_multipart()
        f_py = server2.recv_multipart()
        assert f_native == f_py, (f_native[0], f_py[0])

    native.close()
    py.close()
    server.close()
    server2.close()


def test_streaming_with_native_publisher(workload):
    """A short streaming run through the C++ publisher reaches a local
    receiver with the expected message sequence."""
    import threading

    from slam_tpu.runtime import Runner
    from slam_tpu.runtime.telemetry import ZmqPairSocket

    ep = "tcp://127.0.0.1:45459"
    server = ZmqPairSocket(ep, bind=True)
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
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=12)
    plot = NativeNetworkPlot(ep)
    result = runner.run_streaming(seed=1, n_ticks=160, plot=plot)
    plot.close()
    t.join(timeout=30)
    server.close()

    assert received.count("plot") == len(result.true_pose)
    assert "setParticles" in received          # FastSLAM cloud path
    assert received[-1] == "endPlot"
