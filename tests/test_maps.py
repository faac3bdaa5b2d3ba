import numpy as np
import pytest

from slam_tpu.maps import (
    REFERENCE_LIKE,
    read_map_file,
    synthetic_map,
    write_map_file,
    write_reference_like,
)


def test_read_webmap(webmap_map):
    assert webmap_map.landmarks.shape == (35, 2)
    assert webmap_map.waypoints.shape == (17, 2)
    # The loop starts half a segment behind waypoint 0, heading +x.
    assert webmap_map.waypoints[0, 0] > 0.0
    np.testing.assert_allclose(webmap_map.waypoints[0, 1], 0.0, atol=1e-5)
    np.testing.assert_allclose(webmap_map.waypoints[-1],
                               -webmap_map.waypoints[0], atol=1e-5)


def test_read_all_reference_maps(map_path):
    sizes = {
        "loop1_like": (22, 33),
        "loop2_like": (25, 30),
        "loop902_like": (117, 24),
        "webmap_like": (35, 17),
    }
    for name, (n_lm, n_wp) in sizes.items():
        m = read_map_file(map_path(name))
        assert m.n_landmarks == n_lm, name
        assert m.n_waypoints == n_wp, name


@pytest.mark.parametrize("name", sorted(REFERENCE_LIKE))
def test_committed_maps_match_generator(name, map_path, tmp_path):
    """data/*_like.{mat,ini} are exactly what tools/make_maps.py writes."""
    for path in write_reference_like(name, str(tmp_path)):
        ext = path.rsplit(".", 1)[1]
        with open(path) as fh, open(map_path(name, ext)) as committed:
            assert fh.read() == committed.read(), (name, ext)


def test_reference_like_landmarks_line_the_path(map_path):
    """Every landmark lies within the sensor range of the waypoint loop,
    so each one can be observed."""
    from slam_tpu.config import SlamConfig
    for name in REFERENCE_LIKE:
        m = read_map_file(map_path(name))
        cfg = SlamConfig.from_ini(map_path(name, "ini"))
        wp = np.vstack([m.waypoints, m.waypoints[:1]])
        a, b = wp[:-1], wp[1:]
        d = b - a
        t = np.clip(np.einsum("lsk,sk->ls", m.landmarks[:, None] - a[None],
                              d) / np.sum(d * d, axis=1), 0.0, 1.0)
        near = a[None] + t[..., None] * d[None]
        dist = np.linalg.norm(m.landmarks[:, None] - near, axis=-1).min(1)
        assert dist.max() < cfg.MAX_RANGE, name


def test_roundtrip(tmp_path, webmap_map):
    p = tmp_path / "m.mat"
    write_map_file(str(p), webmap_map)
    m2 = read_map_file(str(p))
    np.testing.assert_allclose(m2.landmarks, webmap_map.landmarks, atol=1e-5)
    np.testing.assert_allclose(m2.waypoints, webmap_map.waypoints, atol=1e-5)


def test_synthetic_map():
    m = synthetic_map(10_000, n_waypoints=64, seed=3)
    assert m.landmarks.shape == (10_000, 2)
    assert m.waypoints.shape == (64, 2)
    ext = m.extent()
    assert ext[0] < ext[1] and ext[2] < ext[3]
