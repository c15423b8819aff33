"""Op-level tests: bit-packed lookups and one-hot lookups vs the raster."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.maps import from_map_file, from_walls
from montecarlolocalisation.ops import bitlookup, lookup

import os.path as osp

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def _exhaustive_indices(h, w, margin=2):
    my, mx = np.meshgrid(np.arange(-margin, h + margin),
                         np.arange(-margin, w + margin), indexing="ij")
    return my.ravel(), mx.ravel()


def test_bitlookup_matches_raster_exhaustively():
    m = from_map_file(MAP_PATH)
    occ = np.asarray(m.occ)
    fn = bitlookup.make_bit_lookup(occ)
    my, mx = _exhaustive_indices(*occ.shape)
    got = np.asarray(fn(jnp.asarray(my), jnp.asarray(mx)))
    inb = (my >= 0) & (mx >= 0) & (my < occ.shape[0]) & (mx < occ.shape[1])
    want = np.zeros_like(got)
    want[inb] = occ[my[inb], mx[inb]]
    np.testing.assert_array_equal(got, want)


def test_bitlookup_dilated_general_path():
    m = from_map_file(MAP_PATH)
    dil = np.asarray(m.occ_dilated)
    # Dilated raster is NOT gridline-structured -> general select chain.
    assert not bitlookup._is_gridline_structured(dil)
    fn = bitlookup.make_bit_lookup(dil)
    my, mx = _exhaustive_indices(*dil.shape)
    got = np.asarray(fn(jnp.asarray(my), jnp.asarray(mx)))
    inb = (my >= 0) & (mx >= 0) & (my < dil.shape[0]) & (mx < dil.shape[1])
    want = np.zeros_like(got)
    want[inb] = dil[my[inb], mx[inb]]
    np.testing.assert_array_equal(got, want)


def test_bitlookup_gridline_detection():
    m = from_map_file(MAP_PATH)
    assert bitlookup._is_gridline_structured(np.asarray(m.occ))
    # Ragged map pads full blocks -> off-grid pixels.
    ragged = from_walls([[[1], [1]], [[1]]])
    assert not bitlookup._is_gridline_structured(np.asarray(ragged.occ))
    fn = bitlookup.make_bit_lookup(np.asarray(ragged.occ))
    occ = np.asarray(ragged.occ)
    my, mx = _exhaustive_indices(*occ.shape, margin=1)
    got = np.asarray(fn(jnp.asarray(my), jnp.asarray(mx)))
    inb = (my >= 0) & (mx >= 0) & (my < occ.shape[0]) & (mx < occ.shape[1])
    want = np.zeros_like(got)
    want[inb] = occ[my[inb], mx[inb]]
    np.testing.assert_array_equal(got, want)


def test_onehot_lookup_matches_raster():
    m = from_map_file(MAP_PATH)
    occ = np.asarray(m.occ)
    my, mx = _exhaustive_indices(*occ.shape)
    got = np.asarray(lookup.onehot_lookup_2d(
        m.occ_f, jnp.asarray(my), jnp.asarray(mx)))
    inb = (my >= 0) & (mx >= 0) & (my < occ.shape[0]) & (mx < occ.shape[1])
    want = np.zeros_like(got)
    want[inb] = occ[my[inb], mx[inb]]
    np.testing.assert_array_equal(got, want)


def test_beam_weights_backends_agree():
    import math

    from montecarlolocalisation.config import SensorModelConfig
    from montecarlolocalisation.models import resample, sensor

    m = from_map_file(MAP_PATH)
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    cfg_g = SensorModelConfig(ray_mode="fixed", lookup_mode="gather")
    cfg_b = SensorModelConfig(ray_mode="fixed", lookup_mode="bits")
    cfg_o = SensorModelConfig(ray_mode="fixed", lookup_mode="onehot")
    parts = resample.sample_uniform_particles(jax.random.PRNGKey(0), m, 2048)
    scan = sensor.simulate_scan(m, jnp.array([1.25, 1.25, 0.0]), angles,
                                cfg_g)
    wg = np.asarray(sensor.beam_weights(m, parts, scan, cfg_g))
    wb = np.asarray(sensor.beam_weights(m, parts, scan, cfg_b))
    wo = np.asarray(sensor.beam_weights(m, parts, scan, cfg_o))
    np.testing.assert_allclose(wg, wb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wg, wo, rtol=1e-5, atol=1e-5)


def test_valid_pos_dilated_matches_stencil():
    from montecarlolocalisation.maps import grid

    m = from_map_file(MAP_PATH)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.uniform(-0.3, 5.2, 4096), jnp.float32)
    ys = jnp.asarray(rng.uniform(-0.3, 5.2, 4096), jnp.float32)
    fast = np.asarray(grid.is_valid_pos(m, xs, ys))
    exact = np.asarray(grid.is_valid_pos_stencil(m, xs, ys))
    # Identical away from float pixel-boundary ties.
    assert (fast == exact).mean() > 0.999


@pytest.mark.slow
def test_stage_knockout_times_smoke():
    # Tiny config on CPU: all marginals finite, stand-ins preserve shapes.
    import os.path as osp

    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import FilterConfig
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.models import filter as mcl, sensor
    from montecarlolocalisation.utils.profiling import (
        stage_knockout_times,
    )

    m = from_map_file(osp.join(
        osp.dirname(__file__), "..", "montecarlolocalisation", "maps",
        "default_map.txt"))
    cfg = FilterConfig(num_particles=256)
    import numpy as np
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 8)),
                         jnp.float32)
    state = mcl.init_state(jax.random.PRNGKey(0), m, cfg)
    scan = sensor.simulate_scan(m, jnp.array([1.25, 1.25, 0.0]), angles,
                                cfg.sensor)
    out = stage_knockout_times(m, cfg, scan, state, iters=2)
    assert set(out) == {"full", "marginal_motion", "marginal_weights",
                        "marginal_resample", "marginal_cluster"}
    assert all(np.isfinite(v) for v in out.values())


def test_stage_knockout_full_matches_mcl_step():
    # Lockstep guard: the profiler's no-knockout step must reproduce the
    # REAL mcl_step bit-exactly (same key splits, stage order, state
    # wiring) -- otherwise marginals silently mis-attribute time after
    # any mcl_step refactor.
    import os.path as osp

    import jax
    import jax.numpy as jnp
    import numpy as np

    from montecarlolocalisation.config import FilterConfig
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.models import filter as mcl, sensor
    from montecarlolocalisation.utils import profiling

    m = from_map_file(osp.join(
        osp.dirname(__file__), "..", "montecarlolocalisation", "maps",
        "default_map.txt"))
    cfg = FilterConfig(num_particles=256)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 8)), jnp.float32)
    state = mcl.init_state(jax.random.PRNGKey(5), m, cfg)
    scan = sensor.simulate_scan(m, jnp.array([1.25, 1.25, 0.0]), angles,
                                cfg.sensor)
    # Reach into the profiler's internal step via a 1-iteration run that
    # returns states: emulate by re-deriving the step the same way.
    enc = jnp.float32(0.1)
    want, _ = mcl.mcl_step(state, enc, enc, scan, m, cfg)
    # Build the knockout step with no knockouts by calling the API with
    # iters=1 (timing ignored) and separately re-running its internals:
    # the public contract we can check cheaply is that full-step timing
    # runs the REAL math; assert via the state produced by a no-skip step
    # constructed identically.
    got_state = profiling._knockout_step(m, cfg, scan, state, enc, ())
    np.testing.assert_array_equal(np.asarray(got_state.particles),
                                  np.asarray(want.particles))
    np.testing.assert_array_equal(np.asarray(got_state.best_pose),
                                  np.asarray(want.best_pose))
    assert float(got_state.confidence) == float(want.confidence)
