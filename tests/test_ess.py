"""ESS-gated resampling (cfg.resample.ess_threshold) tests.

The opt-in production SIR schedule: carried cumulative weights, full
resampling pass only when ESS = 1/sum(w_hat^2) < ess_threshold * N.
The default (ess_threshold=None) is the reference's every-tick schedule
(monte_carlo.cpp:457-561) and is covered by the existing resample/filter
tests; these tests cover the gate itself.
"""
import dataclasses
import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (
    FilterConfig, ResampleConfig, SensorModelConfig,
)
from montecarlolocalisation.maps import from_map_file, from_walls
from montecarlolocalisation.models import filter as mcl
from montecarlolocalisation.models import resample
from montecarlolocalisation.sim import robot

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")
SMALL_MAP = from_walls([[[0, 1, 2], [1], [0, 1]],
                        [[2, 3], [3], [0, 3]]])
FALSE = jnp.bool_(False)


def _cfg(n=512, tau=0.5, **kw):
    return FilterConfig(
        num_particles=n,
        resample=ResampleConfig(method="systematic", ess_threshold=tau),
        **kw)


def _uniform_setup(n, key):
    parts = resample.sample_uniform_particles(key, SMALL_MAP, n)
    carried = jnp.full((n,), 1.0 / n, jnp.float32)
    return parts, carried


def test_skip_branch_preserves_particles():
    """Near-uniform likelihood -> high ESS -> particles pass through
    untouched and weights are the normalized product."""
    n = 512
    parts, carried = _uniform_setup(n, jax.random.PRNGKey(0))
    like = jnp.full((n,), 0.3, jnp.float32)
    p2, w2, inj2, info = resample.ess_gated_resample(
        jax.random.PRNGKey(1), parts, like, carried,
        resample.InjectionState.zero(), FALSE, SMALL_MAP, _cfg(n))
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(parts))
    np.testing.assert_allclose(np.asarray(w2), 1.0 / n, rtol=1e-6)
    assert int(info["n_injected"]) == 0
    # Injection bookkeeping still ran (w_slow/w_fast moved off zero).
    assert float(inj2.w_slow) > 0.0
    assert float(inj2.w_fast) > 0.0


def test_skewed_weights_trigger_resample():
    """A likelihood spike on a few particles collapses ESS -> the draw
    runs, weights reset to 1/N, and survivors cluster near the spike."""
    n = 512
    parts, carried = _uniform_setup(n, jax.random.PRNGKey(2))
    like = jnp.where(jnp.arange(n) < 8, 100.0, 1e-4).astype(jnp.float32)
    cfg = _cfg(n)
    p2, w2, inj2, info = resample.ess_gated_resample(
        jax.random.PRNGKey(3), parts, like, carried,
        resample.InjectionState(jnp.float32(1.0), jnp.float32(1.0)),
        FALSE, SMALL_MAP, cfg)
    np.testing.assert_allclose(np.asarray(w2), 1.0 / n, rtol=1e-6)
    # Essentially every draw must come from the 8 spiked particles: the
    # drawn xy (mod the confident-regime 0.01 jitter) matches one of them.
    spiked = np.asarray(parts[:8, :2])
    d = np.abs(np.asarray(p2)[:, None, :2] - spiked[None]).max(-1).min(-1)
    assert (d < 0.011).mean() > 0.95


def test_carried_weights_accumulate_across_skips():
    """While the gate holds, weights multiply in the likelihood each tick."""
    n = 256
    parts, carried = _uniform_setup(n, jax.random.PRNGKey(4))
    # Mild tilt: not enough to trip tau=0.1 in a couple of ticks.
    like = jnp.linspace(0.9, 1.1, n).astype(jnp.float32)
    cfg = _cfg(n, tau=0.1)
    w = carried
    for i in range(3):
        parts, w, _, _ = resample.ess_gated_resample(
            jax.random.PRNGKey(5 + i), parts, like, w,
            resample.InjectionState.zero(), FALSE, SMALL_MAP, cfg)
    expect = np.asarray(carried) * np.asarray(like) ** 3
    expect /= expect.sum()
    np.testing.assert_allclose(np.asarray(w), expect, rtol=1e-4)


def test_zero_likelihood_normalizes_uniform_and_skips():
    n = 128
    parts, carried = _uniform_setup(n, jax.random.PRNGKey(6))
    like = jnp.zeros((n,), jnp.float32)
    p2, w2, _, info = resample.ess_gated_resample(
        jax.random.PRNGKey(7), parts, like, carried,
        resample.InjectionState.zero(), FALSE, SMALL_MAP, _cfg(n, tau=0.9))
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(parts))
    np.testing.assert_allclose(np.asarray(w2), 1.0 / n, rtol=1e-6)


def test_default_none_is_reference_path(maze_cfg=None):
    """ess_threshold=None must leave mcl_step's output bit-identical to the
    pre-gate code path (the gate is compiled out)."""
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=256)
    assert cfg.resample.ess_threshold is None
    from montecarlolocalisation.models import sensor
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    st = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    scan = sensor.simulate_scan(
        maze, jnp.array([1.25, 1.25, 0.0]), angles, cfg.sensor)
    st2, out = jax.jit(functools.partial(mcl.mcl_step, m=maze, cfg=cfg))(
        st, jnp.float32(0.0), jnp.float32(0.0), scan)
    # Structural check: weights are the post-resample uniform 1/N (the
    # carried-weight path would generally NOT be uniform).
    np.testing.assert_allclose(np.asarray(st2.weights), 1.0 / 256, rtol=1e-6)


def test_tracking_with_ess_gate(request):
    """End-to-end: tracking an episode with tau=0.5 stays locked with RMSE
    comparable to the every-tick schedule (test_filter's bound)."""
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(
        num_particles=500,
        sensor=SensorModelConfig(ray_mode="dda", beam_skip=20),
        resample=ResampleConfig(method="systematic", ess_threshold=0.5))
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(7), maze, cfg, angles, num_ticks=200,
        start_pose=(2.05, 2.05, 0.0))
    st = mcl.init_state(jax.random.PRNGKey(4), maze, cfg)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    n = cfg.num_particles
    start = np.asarray(poses[0])
    parts = jnp.stack([
        start[0] + 0.03 * jax.random.normal(k1, (n,)),
        start[1] + 0.03 * jax.random.normal(k2, (n,)),
        start[2] + 0.05 * jax.random.normal(k3, (n,))], axis=-1)
    st = dataclasses.replace(
        st, particles=parts.astype(jnp.float32),
        confidence=jnp.float32(1.0), cluster_threshold=jnp.float32(0.4),
        confident_threshold=jnp.float32(0.5),
        best_pose=jnp.asarray(start, jnp.float32))
    run = jax.jit(functools.partial(mcl.run_episode, m=maze, cfg=cfg))
    final, outs = run(st, enc, ranges, angles)
    est = np.asarray(outs.exact_pose)[1:]
    truth = np.asarray(poses)[:-1]
    ok = est[:, 0] >= 0
    assert ok.mean() > 0.7, "tracking lost confidence under the ESS gate"
    err = np.hypot(est[ok, 0] - truth[ok, 0], est[ok, 1] - truth[ok, 1])
    rmse = float(np.sqrt((err**2).mean()))
    assert rmse < 0.2, f"ESS-gated tracking RMSE {rmse:.3f} m"


def test_gate_fires_some_skips_in_tracking():
    """Directly count skipped ticks in a short tracking run (skips show as
    ticks whose post-step weights are NOT uniform 1/N)."""
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(
        num_particles=300,
        sensor=SensorModelConfig(ray_mode="dda", beam_skip=20),
        resample=ResampleConfig(method="systematic", ess_threshold=0.5))
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(9), maze, cfg, angles, num_ticks=40,
        start_pose=(2.05, 2.05, 0.0))
    st = mcl.init_state(jax.random.PRNGKey(1), maze, cfg)
    start = np.asarray(poses[0])
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(2), 3)
    n = cfg.num_particles
    parts = jnp.stack([
        start[0] + 0.02 * jax.random.normal(k1, (n,)),
        start[1] + 0.02 * jax.random.normal(k2, (n,)),
        start[2] + 0.03 * jax.random.normal(k3, (n,))], axis=-1)
    st = dataclasses.replace(
        st, particles=parts.astype(jnp.float32),
        confidence=jnp.float32(1.0), cluster_threshold=jnp.float32(0.4),
        confident_threshold=jnp.float32(0.5),
        best_pose=jnp.asarray(start, jnp.float32))
    skips = 0
    step = jax.jit(functools.partial(mcl.mcl_step, m=maze, cfg=cfg))
    from montecarlolocalisation.models import sensor as snsr
    for t in range(enc.shape[0]):
        sc = snsr.Scan(angles=jnp.asarray(angles), ranges=ranges[t],
                       mask=jnp.ones((angles.shape[0],), bool))
        st, out = step(st, enc[t, 0], enc[t, 1], sc)
        w = np.asarray(st.weights)
        if not np.allclose(w, 1.0 / n, rtol=1e-5):
            skips += 1
    assert skips > 0, "ESS gate never skipped in a locked tracking run"
