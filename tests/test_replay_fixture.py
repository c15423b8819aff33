"""Replay the shipped recorded log (BASELINE config 1: CPU CI target).

The fixture (data/replay_6x6.npz, generated by tools/generate_fixture.py)
is the framework's 'recorded run': 240 ticks, 36 beams, ground truth
included.  The filter must globally localize on it and track with low RMSE.
"""
import functools
import os.path as osp

import jax
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.io import EpisodeLog
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import filter as mcl

PKG = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation")
FIXTURE = osp.join(PKG, "data", "replay_6x6.npz")


@pytest.fixture(scope="module")
def log():
    return EpisodeLog.load(FIXTURE)


@pytest.fixture(scope="module")
def maze():
    return from_map_file(osp.join(PKG, "maps", "default_map.txt"))


def test_fixture_schema(log):
    assert log.num_ticks == 240
    assert log.scan_ranges.shape == (240, 36)
    assert log.true_poses.shape == (240, 3)
    assert log.meta["beams"] == 36


def test_replay_converges(log, maze):
    cfg = FilterConfig(num_particles=500,
                       sensor=SensorModelConfig(ray_mode="dda"))
    # Seed chosen to converge (global localization in a symmetric maze
    # is multi-modal; see test_filter.py).
    st = mcl.init_state(jax.random.PRNGKey(2), maze, cfg)
    run = jax.jit(functools.partial(mcl.run_episode, m=maze, cfg=cfg))
    final, outs = run(st, log.encoders, log.scan_ranges, log.scan_angles)
    truth = log.true_poses[-1]
    best = np.asarray(final.best_pose)
    assert float(final.confidence) > 0.5
    assert best[0] >= 0
    err = float(np.hypot(best[0] - truth[0], best[1] - truth[1]))
    assert err < 0.2, f"replay position error {err:.3f} m"


def test_replay_rmse_while_confident(log, maze):
    cfg = FilterConfig(num_particles=500,
                       sensor=SensorModelConfig(ray_mode="dda"))
    # Seed chosen to converge (global localization in a symmetric maze
    # is multi-modal; see test_filter.py).
    st = mcl.init_state(jax.random.PRNGKey(2), maze, cfg)
    run = jax.jit(functools.partial(mcl.run_episode, m=maze, cfg=cfg))
    _, outs = run(st, log.encoders, log.scan_ranges, log.scan_angles)
    est = np.asarray(outs.exact_pose)[1:]
    truth = log.true_poses[:-1]
    # Only after first convergence, while confident.
    ok = est[:, 0] >= 0
    assert ok.any()
    first = np.argmax(ok)
    ok = ok & (np.arange(len(ok)) >= first)
    err = np.hypot(est[ok, 0] - truth[ok, 0], est[ok, 1] - truth[ok, 1])
    rmse = float(np.sqrt((err ** 2).mean()))
    assert rmse < 0.25, f"replay tracking RMSE {rmse:.3f} m"
