"""Preset pipeline smoke tests (the launch-file equivalents)."""
import numpy as np
import pytest

from montecarlolocalisation import presets


@pytest.fixture(scope="module")
def world():
    return presets.make_world(num_particles=300, num_beams=16)


def test_localisation_preset(world):
    final, outs, truth = presets.run_localisation(world, num_ticks=60)
    assert np.isfinite(float(final.confidence))
    assert np.asarray(outs.song).shape == (60,)


def test_planning_preset(world):
    path, final, outs = presets.run_planning(
        world, start_cell=(2, 2), goal_cell=(2, 4), num_ticks=40)
    assert path[0] == (2, 2) and path[-1] == (2, 4)
    assert int(final.wp_idx) >= 0
    assert np.isfinite(np.asarray(outs.true_pose)).all()


def test_challenge_preset(world):
    plan, final, outs = presets.run_challenge(world, num_ticks=30)
    assert len(plan.legs) == 4
    assert plan.gold_cost > 0


def test_sweep_preset(world):
    metrics = presets.run_sweep(world, batch=4, num_ticks=30)
    # Base metrics plus the alias-aware set (default map's symmetry group).
    assert {"converged_frac", "rmse_xy", "rmse_theta",
            "alias_rmse_xy", "alias_converged_frac",
            "dominant_mass_mean", "stray_mass_mean",
            "tracking_rmse_xy"} <= set(metrics)
    assert 0.0 <= float(metrics["converged_frac"]) <= 1.0
    assert 0.0 <= float(metrics["alias_converged_frac"]) <= 1.0
    # Mixture decomposition conserves mass: dominant + stray <= 1.
    assert (float(metrics["dominant_mass_mean"])
            + float(metrics["stray_mass_mean"])) <= 1.0 + 1e-5


def test_track_on_coverage_gating(world):
    """_track_on's coverage-aware pair: with the TRUE maze as the
    'learned' map and full coverage, the in-coverage fraction equals the
    unrestricted one over all episodes; with NOTHING explored, it
    reports no-data (n=0, NaN) instead of a false 0.0 — the failure
    mode that made half-explored slam runs read as broken when the
    deterministic eval walk merely exited the mapped region."""
    m = world.maze
    full = np.ones((m.height, m.width), bool)
    out = presets._track_on(m, m, world, 60, seed=5, batch=4,
                            explored_px=full)
    assert out["track_in_coverage_n"] == 4
    assert out["track_in_coverage_frac"] == out["track_on_learned_frac"]
    out0 = presets._track_on(m, m, world, 60, seed=5, batch=4,
                             explored_px=np.zeros_like(full))
    assert out0["track_in_coverage_n"] == 0
    assert np.isnan(out0["track_in_coverage_frac"])


@pytest.mark.slow
def test_tick_chunked_sweep_bit_identical(world):
    """tick_chunk segments must reproduce the single-scan run exactly
    (the per-tick RNG rides in the carried MCLState), including a ragged
    final chunk."""
    import jax
    from montecarlolocalisation.parallel import episodes

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    enc, scans, _ = episodes.simulate_episode_batch(
        k1, world.maze, world.cfg, world.angles, 25, 3,
        start_pose=(2.05, 2.05, 0.0))
    full_final, full_outs = episodes.run_episode_batch(
        k2, world.maze, world.cfg, enc, scans, world.angles)
    ch_final, ch_outs = episodes.run_episode_batch(
        k2, world.maze, world.cfg, enc, scans, world.angles, tick_chunk=10)
    for a, b in zip(jax.tree_util.tree_leaves(full_final),
                    jax.tree_util.tree_leaves(ch_final)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(full_outs),
                    jax.tree_util.tree_leaves(ch_outs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
