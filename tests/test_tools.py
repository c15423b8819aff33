"""Tests for the diagnostic tools (tools/render_episode.py).

The render tool is the rebuild's stand-in for watching the reference's
RViz PoseArray debug topics (monte_carlo.cpp:563-608): a frame strip of
the particle cloud over an episode.  These tests drive the library
surface (run_and_capture / save_strip) on a tiny simulated episode.
"""
import os.path as osp
import sys

import numpy as np
import pytest

TOOLS = osp.join(osp.dirname(__file__), "..", "tools")


@pytest.fixture(scope="module")
def render_episode():
    sys.path.insert(0, TOOLS)
    try:
        import render_episode as mod
    finally:
        sys.path.remove(TOOLS)
    return mod


def test_run_and_capture_frames(render_episode, default_map, tmp_path):
    import jax

    from montecarlolocalisation.config import (
        FilterConfig, SensorModelConfig,
    )
    from montecarlolocalisation.io.logs import EpisodeLog
    from montecarlolocalisation.sim import robot

    m = default_map
    cfg = FilterConfig(num_particles=128, sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, 8)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(0), m, cfg, angles, 12)
    log = EpisodeLog(encoders=np.asarray(enc),
                     scan_ranges=np.asarray(ranges),
                     scan_angles=angles, true_poses=np.asarray(poses))

    frames, labels = render_episode.run_and_capture(m, cfg, log, every=4,
                                                    scale=2)
    # Ticks 0, 4, 8 and the final tick 11.
    assert labels == [0, 4, 8, 11]
    assert len(frames) == 4
    h, w, c = frames[0].shape
    assert c == 3 and h == m.occ.shape[0] * 2 and w == m.occ.shape[1] * 2
    assert all(f.shape == frames[0].shape for f in frames)
    assert all(f.dtype == np.uint8 for f in frames)
    # Particle cloud must actually be drawn (frames differ over time as
    # the filter converges).
    assert any(not np.array_equal(frames[0], f) for f in frames[1:])

    strip_path = str(tmp_path / "strip.ppm")
    render_episode.save_strip(frames, strip_path, max_frames=3)
    with open(strip_path, "rb") as f:
        header = f.read(2)
    assert header == b"P6"


def test_save_strip_subsamples(render_episode, tmp_path):
    frames = [np.full((4, 6, 3), i, np.uint8) for i in range(10)]
    path = str(tmp_path / "s.ppm")
    render_episode.save_strip(frames, path, max_frames=4)
    with open(path, "rb") as f:
        data = f.read()
    # 4 frames of 6 px wide concatenated horizontally -> width 24.
    assert b"24 4" in data
