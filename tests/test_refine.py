"""Gradient-guided particle refinement (models/refine, opt-in).

No reference counterpart (monte_carlo.cpp's caster is not differentiable);
asserts the autodiff scan-matching behaves: gradients exist and are finite
through both exact casters, hill-climbing never lowers a particle's
likelihood, displaced particles move toward the true pose, and the filter
step integrates it (iters=0 stays bit-identical to the reference path).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, RefineConfig
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import filter as mcl
from montecarlolocalisation.models import refine, sensor

MAP = "montecarlolocalisation/maps/default_map.txt"
ANGLES = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
TRUE_POSE = jnp.array([2.05, 2.05, 0.3], jnp.float32)


@pytest.fixture(scope="module")
def maze():
    return from_map_file(MAP)


@pytest.fixture(scope="module")
def scan(maze):
    cfg = FilterConfig()
    return sensor.simulate_scan(maze, TRUE_POSE, jnp.asarray(ANGLES),
                                cfg.sensor)


def _displaced(n=16, spread=0.08, seed=0):
    off = jax.random.uniform(jax.random.PRNGKey(seed), (n, 3),
                             minval=-spread, maxval=spread)
    return TRUE_POSE[None, :] + off


@pytest.mark.parametrize("ray_mode", ["dda", "analytic"])
def test_gradients_finite_and_nonzero(maze, scan, ray_mode):
    cfg = FilterConfig(refine=RefineConfig(iters=1, ray_mode=ray_mode))
    parts = _displaced()
    w, g = refine.likelihood_and_grad(maze, parts, scan, cfg.sensor,
                                      cfg.refine)
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.linalg.norm(g)) > 0.1
    assert bool(jnp.all(w > 0))


def test_casters_agree_on_gradient(maze, scan):
    cfg = FilterConfig()
    parts = _displaced()
    _, g_dda = refine.likelihood_and_grad(
        maze, parts, scan, cfg.sensor, RefineConfig(iters=1, ray_mode="dda"))
    _, g_ana = refine.likelihood_and_grad(
        maze, parts, scan, cfg.sensor,
        RefineConfig(iters=1, ray_mode="analytic"))
    np.testing.assert_allclose(np.asarray(g_dda), np.asarray(g_ana),
                               atol=1e-4)


@pytest.mark.parametrize("filter_ray_mode", ["fixed", "dda"])
def test_hill_climb_never_worsens_likelihood(maze, scan, filter_ray_mode):
    # Acceptance runs under the FILTER's own sensor model (including the
    # reference's step-quantized "fixed" march), so the weights the filter
    # assigns can only improve — for every ray_mode.
    cfg = dataclasses.replace(
        FilterConfig(refine=RefineConfig(iters=3)),
        sensor=dataclasses.replace(FilterConfig().sensor,
                                   ray_mode=filter_ray_mode))
    parts = _displaced(n=64, spread=0.15, seed=3)
    refined = jax.jit(
        lambda p: refine.refine_particles(maze, p, scan, cfg))(parts)
    w0 = sensor.beam_weights(maze, parts, scan, cfg.sensor)
    w1 = sensor.beam_weights(maze, refined, scan, cfg.sensor)
    assert bool(jnp.all(w1 >= w0 - 1e-5))
    assert float(jnp.mean(w1 - w0)) > 0.5  # real improvement, not a no-op


def test_displaced_particles_move_toward_truth(maze, scan):
    cfg = FilterConfig(refine=RefineConfig(iters=4))
    parts = _displaced(n=64, spread=0.08, seed=1)
    refined = refine.refine_particles(maze, parts, scan, cfg)
    d0 = jnp.linalg.norm(parts[:, :2] - TRUE_POSE[:2], axis=1)
    d1 = jnp.linalg.norm(refined[:, :2] - TRUE_POSE[:2], axis=1)
    # Mean xy error shrinks substantially (individual particles may stop
    # at nearby likelihood plateaus).
    assert float(jnp.mean(d1)) < 0.7 * float(jnp.mean(d0))


def test_iters_zero_is_identity(maze, scan):
    cfg = FilterConfig()
    assert cfg.refine.iters == 0
    parts = _displaced()
    out = refine.refine_particles(maze, parts, scan, cfg)
    assert out is parts  # not even a copy: the reference path is untouched


@pytest.mark.slow
def test_mcl_step_with_refinement_runs_and_helps(maze, scan):
    base = FilterConfig(num_particles=256)
    refcfg = dataclasses.replace(base, refine=RefineConfig(iters=2))
    key = jax.random.PRNGKey(5)
    state0 = mcl.init_state(key, maze, base)
    # Seed particles near the truth so one tick measures local tracking.
    parts = _displaced(n=256, spread=0.1, seed=7)
    state0 = dataclasses.replace(state0, particles=parts)
    step = jax.jit(lambda st, cfg: mcl_step_once(st, scan, maze, cfg),
                   static_argnums=1)
    st_plain, _ = step(state0, base)
    st_ref, _ = step(state0, refcfg)
    assert bool(jnp.all(jnp.isfinite(st_ref.particles)))
    # Refined weights concentrate at least as much likelihood mass.
    w_plain = sensor.beam_weights(maze, st_plain.particles, scan,
                                  base.sensor)
    w_ref = sensor.beam_weights(maze, st_ref.particles, scan, base.sensor)
    assert float(jnp.mean(w_ref)) >= 0.95 * float(jnp.mean(w_plain))


def mcl_step_once(st, scan, maze, cfg):
    return mcl.mcl_step(st, jnp.float32(0.0), jnp.float32(0.0), scan,
                        maze, cfg)


@pytest.mark.slow
def test_refinement_under_vmap(maze, scan):
    cfg = FilterConfig(refine=RefineConfig(iters=2))
    parts = jnp.stack([_displaced(n=32, seed=s) for s in range(3)])  # [3,32,3]
    fn = jax.vmap(lambda p: refine.refine_particles(maze, p, scan, cfg))
    out = fn(parts)
    assert out.shape == parts.shape
    assert bool(jnp.all(jnp.isfinite(out)))
