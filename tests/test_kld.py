"""KLD-adaptive particle budgets (models/kld.py + io/server adapt_mode="kld").

No reference counterpart (compile-time N=1500, monte_carlo.cpp:84); this
is Fox's KLD-sampling bound (ROS AMCL's adaptive sizing) driving the
elastic-serving lattice.  Asserts the bin statistic against a NumPy
brute-force count, the Wilson-Hilferty bound against hand-computed
values, the lattice snap, and the live policy end-to-end.
"""
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import FilterConfig, KLDConfig
from montecarlolocalisation.io.server import MCLServer
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import kld, sensor
from montecarlolocalisation.sim import robot
import pytest

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def _numpy_bin_count(parts, m, cfg):
    """Independent brute-force distinct-bin count (same binning rules)."""
    nx = max(1, math.ceil((m.extent_x - m.origin_x) / cfg.bin_xy))
    ny = max(1, math.ceil((m.extent_y - m.origin_y) / cfg.bin_xy))
    nt = max(1, math.ceil(2.0 * math.pi / cfg.bin_theta))
    ix = np.clip(np.floor((parts[:, 0] - m.origin_x) / cfg.bin_xy), 0,
                 nx - 1).astype(np.int64)
    iy = np.clip(np.floor((parts[:, 1] - m.origin_y) / cfg.bin_xy), 0,
                 ny - 1).astype(np.int64)
    it = np.clip(np.floor((parts[:, 2] + math.pi) / cfg.bin_theta), 0,
                 nt - 1).astype(np.int64)
    return len(set(((it * ny + iy) * nx + ix).tolist()))


def test_occupied_bin_count_matches_numpy():
    m = from_map_file(MAP_PATH)
    cfg = KLDConfig(subsample=1 << 20)  # no subsampling: exact count
    key = jax.random.PRNGKey(0)
    parts = jnp.stack([
        jax.random.uniform(key, (4096,), minval=0.0, maxval=4.8),
        jax.random.uniform(jax.random.fold_in(key, 1), (4096,),
                           minval=0.0, maxval=4.8),
        jax.random.uniform(jax.random.fold_in(key, 2), (4096,),
                           minval=-math.pi, maxval=math.pi),
    ], axis=-1)
    k = int(kld.occupied_bin_count(parts, m, cfg))
    assert k == _numpy_bin_count(np.asarray(parts), m, cfg)


def test_subsample_finds_clustered_bins():
    """A strided subsample still sees every bin of a few-mode cloud."""
    m = from_map_file(MAP_PATH)
    cfg = KLDConfig(subsample=256)
    modes = jnp.array([[0.5, 0.5, 0.0], [2.5, 2.5, 1.0], [4.0, 1.0, -2.0]])
    parts = jnp.tile(modes, (1000, 1))  # 3000 particles, 3 bins
    k = int(kld.occupied_bin_count(parts, m, cfg))
    assert k == 3


def test_kld_target_wilson_hilferty_values():
    cfg = KLDConfig(epsilon=0.05, z=2.326)

    def expected(k):
        a = 2.0 / (9.0 * (k - 1))
        return (k - 1) / (2 * 0.05) * (1 - a + math.sqrt(a) * 2.326) ** 3

    for k in (2, 5, 36, 500):
        got = float(kld.kld_target(jnp.int32(k), cfg))
        np.testing.assert_allclose(got, expected(k), rtol=1e-5)
    # Degenerate single-bin cloud needs no statistical resolution.
    assert float(kld.kld_target(jnp.int32(1), cfg)) == 1.0
    # Monotone in k; approaches (k-1)/2eps from above at large k.
    ns = [float(kld.kld_target(jnp.int32(k), cfg)) for k in range(2, 200)]
    assert all(b > a for a, b in zip(ns, ns[1:]))
    ratio = float(kld.kld_target(jnp.int32(1000), cfg)) / (999 / 0.1)
    assert 1.0 < ratio < 1.2


def test_lattice_size_snap():
    m = from_map_file(MAP_PATH)
    srv = MCLServer(m, FilterConfig(num_particles=1024),
                    np.zeros(4, np.float32), adapt=(100, 1024),
                    adapt_mode="kld")
    # Halving lattice {1024, 512, 256, 128}: 64 < n_min stops the walk.
    assert srv._lattice_size(1.0) == 128
    assert srv._lattice_size(128.0) == 128
    assert srv._lattice_size(129.0) == 256
    assert srv._lattice_size(600.0) == 1024
    assert srv._lattice_size(50000.0) == 1024


def test_kld_policy_grows_immediately_shrinks_with_patience():
    m = from_map_file(MAP_PATH)
    srv = MCLServer(m, FilterConfig(num_particles=1024),
                    np.zeros(4, np.float32), adapt=(128, 1024),
                    adapt_mode="kld", adapt_patience=3)
    srv._set_particle_count(128)
    ok = dict(song=0, confidence=1.0)
    # Under-sampled -> grow NOW to the covering lattice size.
    srv._maybe_adapt(ok, kld_target=2000.0)
    assert srv.num_particles == 1024
    # Over-sampled -> one halving only after `adapt_patience` agreeing
    # ticks, then the counter resets.
    for _ in range(2):
        srv._maybe_adapt(ok, kld_target=1.0)
        assert srv.num_particles == 1024
    srv._maybe_adapt(ok, kld_target=1.0)
    assert srv.num_particles == 512
    srv._maybe_adapt(ok, kld_target=1.0)
    assert srv.num_particles == 512
    # Lost song snaps to n_max regardless of the statistic.
    srv._maybe_adapt(dict(song=1, confidence=0.0), kld_target=1.0)
    assert srv.num_particles == 1024


@pytest.mark.slow
def test_server_kld_live_shrink_and_kidnap_recovery():
    m = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=1024)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(0), m, cfg, angles, 120,
        start_pose=(2.05, 2.05, 0.0))
    enc, scans = np.asarray(enc), np.asarray(scans)

    srv = MCLServer(m, cfg, angles, seed=3, adapt=(128, 1024),
                    adapt_mode="kld", adapt_patience=8)
    sizes, targets = [], []
    for t in range(120):
        out = srv.tick(enc[t, 0], enc[t, 1], scans[t])
        sizes.append(out["particles"])
        targets.append(out["kld_target"])
    # Once tracking locks, the occupied-bin count collapses and the
    # budget follows it down the lattice.
    assert min(sizes) < 1024, sizes
    assert min(targets) < 1024, targets

    # Kidnap: the lost snap (or the dispersing cloud's growing bin count)
    # must restore the full budget for global re-localization.
    far_scan = sensor.simulate_scan(
        m, jnp.array([0.45, 4.45, 2.0], jnp.float32),
        jnp.asarray(angles), cfg.sensor)
    grew = False
    for _ in range(60):
        out = srv.tick(0.0, 0.0, np.asarray(far_scan.ranges))
        if out["particles"] == 1024:
            grew = True
            break
    assert grew, f"budget stayed at {srv.num_particles} after kidnap"
