"""RBPF SLAM (models/slam.py).

No reference counterpart (the reference localizes against a hand-written
map.txt and cannot estimate pose and map jointly); tests pin the
likelihood-field math (banded-matmul blur, gather-free bilinear sampling),
the SIR invariants (weights, ESS gate, map-carrying resample), jit/scan
composition, and — at sweep level, not single pinned seeds — that SLAM
bounds the pose drift dead reckoning accumulates under wheel slip while
producing a usable map.
"""
import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import (FilterConfig, MappingConfig,
                                               SLAMConfig)
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import mapping, slam
from montecarlolocalisation.sim import robot
import pytest

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def _maze():
    return from_map_file(MAP_PATH)


def _cfg(m, **kw):
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    return SLAMConfig(mapping=mc, **kw)


# ---------------------------------------------------------------------------
# Field / sampling math
# ---------------------------------------------------------------------------
def test_blur_matrix_unit_center_and_band():
    k = np.asarray(slam._blur_matrix(9, sigma_px=1.5, radius=3))
    assert np.allclose(np.diag(k), 1.0)          # unit center weight
    assert k[0, 4] == 0.0                        # outside radius
    assert np.isclose(k[0, 3], np.exp(-0.5 * (3.0 / 1.5) ** 2), atol=1e-6)
    d1 = np.exp(-0.5 * (1.0 / 1.5) ** 2)
    assert np.isclose(k[2, 3], d1, atol=1e-6)
    assert np.allclose(k, k.T)


def test_hit_field_peak_on_wall_and_decay():
    cfg = _cfg(_maze())
    lo = jnp.zeros((1, 21, 21), jnp.float32).at[0, 10, 10].set(8.0)
    blurred, sharp = slam.hit_field(lo, cfg)
    blurred, sharp = np.asarray(blurred)[0], np.asarray(sharp)[0]
    assert sharp[10, 10] > 0.99
    assert sharp[10, 11] < 0.2                   # sharp field stays local
    assert blurred[10, 10] > 0.99
    d1 = np.exp(-0.5 * (1.0 / cfg.field_sigma_px) ** 2)
    assert np.isclose(blurred[10, 11], d1, atol=1e-2)
    assert blurred[10, 10 + cfg.field_radius_px + 1] == 0.0
    # A single observation already counts as mostly-wall (sharp > 0.8).
    lo1 = jnp.zeros((1, 21, 21), jnp.float32).at[0, 5, 5].set(
        cfg.mapping.l_occ)
    _, sharp1 = slam.hit_field(lo1, cfg)
    assert float(sharp1[0, 5, 5]) > 0.8
    # Unknown (0) and free (negative) cells are near zero.
    assert float(sharp1[0, 0, 0]) < 0.2


def test_bilinear_matches_manual_interpolation():
    cfg = _cfg(_maze())
    mcfg = cfg.mapping
    rng = np.random.default_rng(0)
    field = jnp.asarray(rng.uniform(size=(2, mcfg.height, mcfg.width)),
                        jnp.float32)
    # Points at exact pixel centers read the pixel value.
    r, c = 7, 11
    ex = jnp.full((2, 1), mcfg.origin_x + (c + 0.5) * mcfg.resolution)
    ey = jnp.full((2, 1), mcfg.origin_y + (r + 0.5) * mcfg.resolution)
    got = np.asarray(slam._bilinear(field, ex, ey, mcfg))
    assert np.allclose(got[:, 0], np.asarray(field)[:, r, c], atol=1e-5)
    # A point halfway between two pixel centers reads their average.
    ex2 = ex + 0.5 * mcfg.resolution
    got2 = np.asarray(slam._bilinear(field, ex2, ey, mcfg))
    want = 0.5 * (np.asarray(field)[:, r, c] + np.asarray(field)[:, r, c + 1])
    assert np.allclose(got2[:, 0], want, atol=1e-5)


def test_bilinear_out_of_map_reads_zero():
    """Samples outside the pixel-center hull read ZERO field mass (the
    endpoint scores z_rand only) instead of clamping onto the border cell
    — a particle drifting off the map must not be rewarded by the outer
    wall's own likelihood basin (ADVICE r2)."""
    cfg = _cfg(_maze())
    mcfg = cfg.mapping
    field = jnp.ones((1, mcfg.height, mcfg.width), jnp.float32)
    far = mcfg.origin_x + (mcfg.width + 5.0) * mcfg.resolution
    inside = mcfg.origin_x + 3.5 * mcfg.resolution
    ex = jnp.array([[far, inside]], jnp.float32)
    ey = jnp.array([[inside, -1.0]], jnp.float32)
    got = np.asarray(slam._bilinear(field, ex, ey, mcfg))
    assert np.allclose(got, 0.0)
    # Exactly ON the border pixel center still reads the border value.
    bx = mcfg.origin_x + (mcfg.width - 0.5) * mcfg.resolution
    by = mcfg.origin_y + 0.5 * mcfg.resolution
    got_b = np.asarray(slam._bilinear(
        field, jnp.array([[bx]], jnp.float32),
        jnp.array([[by]], jnp.float32), mcfg))
    assert np.allclose(got_b, 1.0, atol=1e-5)


def test_windowed_field_matches_full_grid_likelihood():
    """On maps larger than field_window_px the likelihood field runs on
    per-particle dynamic_slice windows (cost ~flat in map area).  The
    windowed log-likelihood — endpoint AND free-space terms, near borders
    included — must match the full-grid computation."""
    from montecarlolocalisation.maps import from_walls, generator

    m = from_walls(generator.generate_maze(12, 10, seed=3))
    cfg = _cfg(m, num_particles=8)
    assert slam.field_window_px(cfg) < min(m.height, m.width)
    angles = jnp.asarray(
        np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32))
    rng = np.random.RandomState(0)
    # Build non-trivial per-particle maps: a few scans from spread poses.
    key = jax.random.PRNGKey(1)
    st = slam.init_slam(key, (1.25, 1.25, 0.0), cfg)
    lo = st.logodds
    w_m, h_m = m.width * m.resolution, m.height * m.resolution
    poses = np.stack([
        rng.uniform(0.3, w_m - 0.3, 8),
        rng.uniform(0.3, h_m - 0.3, 8),
        rng.uniform(-np.pi, np.pi, 8)], axis=-1).astype(np.float32)
    # Border poses too: window clamping must not change results.
    poses[0] = (0.35, 0.35, 2.5)
    poses[1] = (w_m - 0.35, h_m - 0.35, -0.7)
    from montecarlolocalisation.models import sensor as sensor_mod

    scans = np.stack([np.asarray(sensor_mod.simulate_scan(
        m, jnp.asarray(p), angles, cfg.sensor).ranges) for p in poses])
    for i in range(8):
        lo = lo.at[i].set(mapping.update_map(
            lo[i], jnp.asarray(poses[i]), jnp.asarray(scans[i]), angles,
            jnp.ones_like(angles), cfg.mapping, cfg.sensor))
    pj = jnp.asarray(poses)
    ranges = jnp.asarray(scans[3])
    mask = jnp.ones_like(angles)

    full = slam.scan_log_likelihood(
        slam.hit_field(lo, cfg), pj, ranges, angles, mask, cfg)
    win, offs = slam.field_windows(lo, pj, cfg)
    assert offs is not None and win.shape[1] == slam.field_window_px(cfg)
    got = slam.scan_log_likelihood(
        slam.hit_field(win, cfg), pj, ranges, angles, mask, cfg, offs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(full),
                               rtol=2e-4, atol=2e-4)


def test_endpoints_follow_reference_beam_geometry():
    m = _maze()
    cfg = _cfg(m)
    poses = jnp.array([[1.0, 2.0, 0.3]], jnp.float32)
    angles = jnp.array([0.4], jnp.float32)
    ranges = jnp.array([0.6], jnp.float32)
    ex, ey = slam._endpoints(poses, ranges, angles, cfg)
    off = cfg.sensor.laser_offset
    ray = 0.3 - 0.4                       # negate_beam_angle quirk
    r = 0.6 + 0.5 * cfg.mapping.resolution  # wall pixel center
    assert np.isclose(float(ex[0, 0]),
                      1.0 + off * np.cos(0.3) + r * np.cos(ray), atol=1e-6)
    assert np.isclose(float(ey[0, 0]),
                      2.0 + off * np.sin(0.3) + r * np.sin(ray), atol=1e-6)


def test_likelihood_prefers_the_consistent_pose():
    """On a map with one learned wall, a particle whose beam endpoint hits
    the wall outscores one displaced half a cell; a particle whose ray
    CROSSES the wall (free-space violation) scores worst of all."""
    m = _maze()
    cfg = _cfg(m)
    mcfg = cfg.mapping
    # Wall pixel at world (2.05, 1.25) -> row 12, col 20.
    lo = jnp.zeros((3, mcfg.height, mcfg.width), jnp.float32)
    lo = lo.at[:, 12, 20].set(8.0)
    angles = jnp.array([0.0], jnp.float32)
    off = cfg.sensor.laser_offset
    # Particle 0: endpoint exactly on the wall pixel center.
    x_hit = 2.05 - 0.5 * mcfg.resolution - off - 0.5
    # Particle 1: endpoint 0.4 m short of the wall.  Particle 2: same
    # pose as 0 but its beam RETURNS past the wall, so interior stations
    # cross the learned wall (free-space violation).
    poses = jnp.array([[x_hit, 1.25, 0.0],
                       [x_hit - 0.4, 1.25, 0.0],
                       [x_hit, 1.25, 0.0]], jnp.float32)
    ranges = jnp.array([0.5], jnp.float32)
    field = slam.hit_field(lo, cfg)
    ll_hit = slam.scan_log_likelihood(
        jax.tree_util.tree_map(lambda f: f[:1], field), poses[:1],
        ranges, angles, jnp.ones((1,)), cfg)
    ll_short = slam.scan_log_likelihood(
        jax.tree_util.tree_map(lambda f: f[1:2], field), poses[1:2],
        ranges, angles, jnp.ones((1,)), cfg)
    ll_cross = slam.scan_log_likelihood(
        jax.tree_util.tree_map(lambda f: f[2:3], field), poses[2:3],
        jnp.array([0.9], jnp.float32), angles, jnp.ones((1,)), cfg)
    assert float(ll_hit[0]) > float(ll_short[0]) > float(ll_cross[0])


# ---------------------------------------------------------------------------
# Filter mechanics
# ---------------------------------------------------------------------------
def test_slam_step_shapes_weights_and_jit():
    m = _maze()
    cfg = _cfg(m, num_particles=16)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 8)), jnp.float32)
    st = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), cfg)
    ranges = jnp.full((8,), 0.4, jnp.float32)
    step = jax.jit(lambda s: slam.slam_step(
        s, jnp.float32(0.3), jnp.float32(0.3), ranges, angles,
        jnp.ones((8,)), cfg))
    st2, info = step(st)
    assert st2.poses.shape == (16, 3)
    assert st2.logodds.shape == (16, cfg.mapping.height, cfg.mapping.width)
    assert np.isclose(float(jnp.sum(st2.weights)), 1.0, atol=1e-5)
    assert info["pose"].shape == (3,)
    assert np.isfinite(np.asarray(info["pose"])).all()
    assert 0.0 < float(info["ess"]) <= 16.0 + 1e-4
    # Maps actually accumulate evidence.
    assert float(jnp.abs(st2.logodds).sum()) > 0.0


def test_resample_carries_maps_with_poses():
    """Force a degenerate weight distribution: after the gated resample
    every survivor must carry the dominant particle's pose AND map."""
    m = _maze()
    cfg = _cfg(m, num_particles=8, ess_threshold=0.99)
    angles = jnp.asarray([0.0], jnp.float32)
    st = slam.init_slam(jax.random.PRNGKey(1), (1.25, 1.25, 0.0), cfg)
    # Particle 3 gets a distinctive map wall and a huge weight.
    lo = st.logodds.at[3, 10, 10].set(8.0)
    w = jnp.full((8,), 1e-6, jnp.float32).at[3].set(1.0)
    st = slam.SLAMState(poses=st.poses, logodds=lo,
                        weights=w / jnp.sum(w), scores=w / jnp.sum(w),
                        odom=st.odom, key=st.key, kf_pose=st.kf_pose)
    st2, info = slam.slam_step(
        st, jnp.float32(0.0), jnp.float32(0.0),
        jnp.asarray([1.0], jnp.float32), angles, jnp.ones((1,)), cfg)
    assert bool(info["resampled"])
    assert np.allclose(np.asarray(st2.weights), 1.0 / 8)
    # Every survivor's map contains particle 3's wall.
    assert np.all(np.asarray(st2.logodds[:, 10, 10]) > 1.0)
    # The MAP estimate selects on the permuted PRE-resample scores, not
    # the now-uniform weights (ADVICE r2): best_map must be a descendant
    # of particle 3 even though argmax(weights) would return particle 0.
    assert not np.allclose(np.asarray(st2.scores), np.asarray(st2.weights))
    assert float(slam.best_map(st2)[10, 10]) > 1.0


def test_slam_motion_guard_inplace_turn():
    """QUIRKS: the reference's rot1 = atan2(~0, ~0) - theta_prev is O(pi)
    garbage during in-place turns, and alpha_1*|rot1| then injects degrees
    of heading noise per tick.  SLAM rebases to rot1 = 0, rot2 = dtheta
    (equivalent when trans ~ 0), so a pure rotation leaves the cloud's
    heading spread at the alpha_1*|dtheta| level, not the alpha_1*pi level.
    The localization filter PRESERVES the quirk (tests/test_parity pins it).
    """
    m = _maze()
    cfg = _cfg(m, num_particles=256, alpha_scale=1.0)
    angles = jnp.asarray([0.0], jnp.float32)
    st = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), cfg)
    # Pure in-place turn: wheels move oppositely by the same amount.
    # dtheta = (d_left - d_right)/wheel_space; pick ~0.2 rad of turn.
    dw = 0.1 * cfg.motion.wheel_space / cfg.motion.wheel_size
    st2, _ = slam.slam_step(st, jnp.float32(dw), jnp.float32(-dw),
                            jnp.asarray([1.0], jnp.float32), angles,
                            jnp.ones((1,)), cfg)
    dtheta = 2 * dw * cfg.motion.wheel_size * 0.5 / cfg.motion.wheel_space
    spread = float(jnp.std(st2.poses[:, 2]))
    # Quirked variance would be ~alpha_1 * pi; the guard caps it at
    # ~2 * alpha_1 * |dtheta|.  Assert we are well under the quirk level.
    a1 = cfg.motion.alpha_1 * cfg.alpha_scale
    assert spread < 3.0 * np.sqrt(2 * a1 * abs(dtheta)) + 1e-3
    assert spread < 0.5 * np.sqrt(a1 * np.pi)
    # And the cloud did turn by ~dtheta.
    assert np.isclose(float(jnp.mean(st2.poses[:, 2])), dtheta, atol=0.05)


def test_run_slam_episode_scan_and_vmap():
    m = _maze()
    fcfg = FilterConfig()
    cfg = _cfg(m, num_particles=16)
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(0), m, fcfg, angles, 12)
    final, est = slam.run_slam_episode(
        jax.random.PRNGKey(1), enc, scans, angles, cfg, (1.25, 1.25, 0.0))
    assert est.shape == (12, 3)
    assert np.isfinite(np.asarray(est)).all()
    # Fleet of SLAM robots: vmap over (key, episode).
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    encs = jnp.stack([enc, enc])
    scs = jnp.stack([scans, scans])
    _, est_b = jax.vmap(lambda k, e, s: slam.run_slam_episode(
        k, e, s, angles, cfg, (1.25, 1.25, 0.0)))(keys, encs, scs)
    assert est_b.shape == (2, 12, 3)


# ---------------------------------------------------------------------------
# End-to-end value: bounded drift + usable map (sweep-level, not one seed)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_slam_bounds_drift_under_wheel_slip():
    """4-episode sweep at 8% wheel slip: SLAM's worst-case final-stretch
    error stays bounded, its mean beats raw dead reckoning, and the
    best-particle map stays usable.  Sweep-level assertions (mean / max
    across seeds), not a hand-picked converging seed."""
    m = _maze()
    fcfg = FilterConfig()
    cfg = _cfg(m, num_particles=64)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    T = 300
    run = jax.jit(lambda k, e, s: slam.run_slam_episode(
        k, e, s, angles, cfg, (1.25, 1.25, 0.0)))
    slam_err, dead_err, f1s = [], [], []
    for seed in (3, 7, 13, 17):
        enc, scans, truth = robot.generate_wander_episode(
            jax.random.PRNGKey(seed), m, fcfg, angles, T, slip_noise=0.08)
        tn = np.asarray(truth)
        dr = np.asarray(mapping.dead_reckon_poses(
            enc, (1.25, 1.25, 0.0), fcfg.motion))
        final, est = run(jax.random.PRNGKey(0), enc, scans)
        est = np.asarray(est)
        slam_err.append(float(np.hypot(est[:, 0] - tn[:, 0],
                                       est[:, 1] - tn[:, 1])[-75:].mean()))
        dead_err.append(float(np.hypot(dr[:, 0] - tn[:, 0],
                                       dr[:, 1] - tn[:, 1])[-75:].mean()))
        walls = mapping.fit_walls(np.asarray(slam.best_map(final)))
        f1s.append(mapping.wall_metrics(walls, np.asarray(m.walls))["f1"])
    assert max(slam_err) < 1.0, (slam_err, dead_err)
    assert np.mean(slam_err) < max(0.45, np.mean(dead_err)), (
        slam_err, dead_err)
    assert min(f1s) > 0.55, f1s


# ---------------------------------------------------------------------------
# Round-4: Monte-Carlo optimal proposal + keyframe-gated map updates
# ---------------------------------------------------------------------------
def test_scan_loglik_multi_matches_single():
    """Every column of the K-candidate scorer must equal the single-pose
    scorer at that candidate (K folds into the sample axis, the math must
    not change)."""
    m = _maze()
    cfg = _cfg(m, num_particles=16)
    key = jax.random.PRNGKey(3)
    lo = jax.random.normal(key, (16, m.height, m.width)) * 2.0
    poses_a = jnp.stack([
        jnp.full((16,), 1.2), jnp.full((16,), 1.3),
        jnp.linspace(-1.0, 1.0, 16)], axis=-1)
    poses_b = poses_a + jnp.asarray([0.07, -0.04, 0.1])
    angles = jnp.asarray(np.deg2rad(np.linspace(-90, 90, 8)), jnp.float32)
    ranges = jnp.full((8,), 0.6, jnp.float32)
    mask = jnp.ones((8,), jnp.float32)
    field = slam.hit_field(lo, cfg)
    multi = slam.scan_loglik_multi(
        field, jnp.stack([poses_a, poses_b], axis=1), ranges, angles,
        mask, cfg)
    single_a = slam.scan_log_likelihood(field, poses_a, ranges, angles,
                                        mask, cfg)
    single_b = slam.scan_log_likelihood(field, poses_b, ranges, angles,
                                        mask, cfg)
    np.testing.assert_allclose(np.asarray(multi[:, 0]),
                               np.asarray(single_a), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(multi[:, 1]),
                               np.asarray(single_b), rtol=1e-5, atol=1e-5)


def test_candidate_proposal_flat_field_is_plain_sir():
    """On an EMPTY map the scan likelihood is candidate-independent, so
    the K-candidate step must behave exactly like plain SIR: candidate
    selection is uniform (the kept pose is a plain motion-model draw) and
    the weight multiplier is constant across particles (weights stay
    uniform)."""
    m = _maze()
    cfg = _cfg(m, num_particles=64, proposal_candidates=4)
    st = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), cfg)
    angles = jnp.asarray(np.deg2rad(np.linspace(-90, 90, 6)), jnp.float32)
    st2, info = slam.slam_step(
        st, jnp.float32(3.0), jnp.float32(3.0),
        jnp.full((6,), 0.5, jnp.float32), angles, jnp.ones((6,)), cfg)
    # Flat likelihood -> uniform weights preserved (no resample trigger).
    np.testing.assert_allclose(np.asarray(st2.weights), 1.0 / 64,
                               rtol=1e-5)
    # The kept poses are motion-model draws: spread matches the plain
    # K=1 proposal's statistics (same alphas), not collapsed.
    cfg1 = _cfg(m, num_particles=64, proposal_candidates=1)
    st1 = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), cfg1)
    st1b, _ = slam.slam_step(
        st1, jnp.float32(3.0), jnp.float32(3.0),
        jnp.full((6,), 0.5, jnp.float32), angles, jnp.ones((6,)), cfg1)
    sp_k = np.asarray(st2.poses)[:, :2].std(axis=0)
    sp_1 = np.asarray(st1b.poses)[:, :2].std(axis=0)
    assert 0.3 < (sp_k.mean() / max(sp_1.mean(), 1e-9)) < 3.0


def test_candidate_proposal_prefers_likely_candidates():
    """With a sharp wall in every particle's map, the kept candidates
    must concentrate where the scan fits: the K-candidate cloud's
    log-likelihood must exceed the plain proposal's on average."""
    m = _maze()
    cfg_k = _cfg(m, num_particles=64, proposal_candidates=8,
                 ess_threshold=0.0)    # no resample: isolate the proposal
    cfg_1 = _cfg(m, num_particles=64, proposal_candidates=1,
                 ess_threshold=0.0)
    angles = jnp.asarray(np.deg2rad(np.linspace(-60, 60, 8)), jnp.float32)

    def run(cfg, seed):
        st = slam.init_slam(jax.random.PRNGKey(seed), (1.25, 1.25, 0.0),
                            cfg)
        # Pre-learned wall ahead: x = 2.0 m (col 20), all particles.
        lo = st.logodds.at[:, :, 20].set(6.0)
        st = dataclasses.replace(st, logodds=lo)
        # True wall at 2.0 - laser_offset... scan says wall 0.65 m ahead.
        ranges = jnp.full((8,), 0.65, jnp.float32)
        st2, _ = slam.slam_step(st, jnp.float32(1.0), jnp.float32(1.0),
                                ranges, angles, jnp.ones((8,)), cfg)
        field = slam.hit_field(st.logodds, cfg)
        ll = slam.scan_log_likelihood(field, st2.poses, ranges, angles,
                                      jnp.ones((8,)), cfg)
        return float(np.mean(np.asarray(ll)))

    gains = [run(cfg_k, s) - run(cfg_1, s) for s in range(3)]
    assert np.mean(gains) > 0.0, gains


def test_keyframe_gating_skips_stationary_updates():
    """With keyframe thresholds set, a stationary robot must not touch
    the maps after the first (sentinel-triggered) update; once it moves a
    keyframe step the update fires again."""
    m = _maze()
    cfg = _cfg(m, num_particles=8, keyframe_trans=0.1,
               keyframe_rot=0.5)
    st = slam.init_slam(jax.random.PRNGKey(2), (1.25, 1.25, 0.0), cfg)
    angles = jnp.asarray(np.deg2rad(np.linspace(-60, 60, 6)), jnp.float32)
    ranges = jnp.full((6,), 0.5, jnp.float32)
    enc = 0.0
    st1, i1 = slam.slam_step(st, jnp.float32(enc), jnp.float32(enc),
                             ranges, angles, jnp.ones((6,)), cfg)
    assert bool(i1["mapped"])                      # sentinel kf_pose
    assert float(jnp.abs(st1.logodds).sum()) > 0.0
    # Stationary ticks: maps frozen.
    st2, i2 = slam.slam_step(st1, jnp.float32(enc), jnp.float32(enc),
                             ranges, angles, jnp.ones((6,)), cfg)
    assert not bool(i2["mapped"])
    np.testing.assert_array_equal(np.asarray(st2.logodds),
                                  np.asarray(st1.logodds))
    # Drive 0.15 m (> keyframe_trans): update fires.
    enc = 2.0 * 0.15 / 0.062                       # wheel arc -> 0.15 m
    st3, i3 = slam.slam_step(st2, jnp.float32(enc), jnp.float32(enc),
                             ranges, angles, jnp.ones((6,)), cfg)
    assert bool(i3["mapped"])
    assert not np.array_equal(np.asarray(st3.logodds),
                              np.asarray(st2.logodds))


def test_keyframe_off_is_bit_identical():
    """keyframe_trans = keyframe_rot = 0 must keep the exact legacy
    program (no cond, same RNG stream, same outputs)."""
    m = _maze()
    cfg = _cfg(m, num_particles=16)
    st = slam.init_slam(jax.random.PRNGKey(4), (1.25, 1.25, 0.0), cfg)
    angles = jnp.asarray(np.deg2rad(np.linspace(-60, 60, 6)), jnp.float32)
    ranges = jnp.full((6,), 0.5, jnp.float32)
    st2, info = slam.slam_step(st, jnp.float32(1.0), jnp.float32(1.0),
                               ranges, angles, jnp.ones((6,)), cfg)
    assert bool(info["mapped"])
    np.testing.assert_array_equal(np.asarray(st2.kf_pose),
                                  np.asarray(info["pose"]))


# ---------------------------------------------------------------------------
# Consensus-anchored correlative correction ("loop closure lite")
# ---------------------------------------------------------------------------
def _painted_state(m, cfg, true_pose, angles, n_paint=2):
    """[P, H, W] log-odds painted from poses AROUND the true pose (as a
    keyframed episode would) with the true maze's own scans — the
    accumulated-evidence fixture the closure matches.  Painting from one
    pose only would leave the observed region a single scan wedge, and
    the closure's frontier-suction gate (rightly) scores no beam whose
    candidate-shifted approach point leaves observed space."""
    from montecarlolocalisation.models import sensor

    tp = np.asarray(true_pose, np.float32)
    lo = jnp.zeros((cfg.mapping.height, cfg.mapping.width), jnp.float32)
    for ddx, ddy in ((0.0, 0.0), (-0.2, 0.0), (0.2, 0.0), (0.0, -0.2),
                     (0.0, 0.2)):
        p = jnp.asarray([tp[0] + ddx, tp[1] + ddy, tp[2]], jnp.float32)
        s = sensor.simulate_scan(m, p, angles, cfg.sensor)
        for _ in range(n_paint):
            lo = mapping.update_map(lo, p, s.ranges, angles, s.mask,
                                    cfg.mapping, cfg.sensor)
    sc = sensor.simulate_scan(m, jnp.asarray(tp, jnp.float32), angles,
                              cfg.sensor)
    return sc, jnp.broadcast_to(lo, (4,) + lo.shape)


def test_closure_recovers_known_offset():
    """A cloud whose mean pose drifted (dx, dy) off the pose its own map
    was painted from must be pulled back by ~the drift (to grid step)."""
    m = _maze()
    cfg = _cfg(m, num_particles=4, closure=True)
    # Dense beams: a sparse fan leaves unobserved gaps BETWEEN rays and
    # the frontier-suction gate (rightly) refuses to match over them.
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 64)),
                         jnp.float32)
    true_pose = (1.25, 1.25, 0.0)
    sc, lo = _painted_state(m, cfg, true_pose, angles)
    w = jnp.full((4,), 0.25, jnp.float32)
    drift = np.array([0.10, -0.05, 0.0], np.float32)
    mean = jnp.asarray(np.asarray(true_pose) + drift)
    delta, gain = slam.closure_correction(lo, w, mean, sc.ranges, angles,
                                          sc.mask, cfg)
    delta = np.asarray(delta)
    assert float(gain) >= cfg.closure_margin
    # Grid step is 0.05 m -> recovery to within one step per axis.
    assert np.all(np.abs(delta[:2] + drift[:2]) <= 0.051), delta
    assert abs(delta[2]) <= 0.04
    # And a rotated cloud recovers heading — measured at a CORNER pose:
    # rotation slides endpoints ALONG extended walls (a corridor gives it
    # almost no signal), so heading observability comes from corners and
    # wall ends, where two orientations pin the slide.
    cfg_t = dataclasses.replace(cfg, closure_margin=0.5)
    angles32 = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 64)),
                           jnp.float32)
    corner = (2.05, 2.05, 0.7)
    sc_t, lo_t = _painted_state(m, cfg_t, corner, angles32)
    drift_t = np.array([0.0, 0.0, 0.08], np.float32)
    mean_t = jnp.asarray(np.asarray(corner) + drift_t)
    delta_t, gain_t = slam.closure_correction(lo_t, w, mean_t, sc_t.ranges,
                                              angles32, sc_t.mask, cfg_t)
    assert float(gain_t) >= cfg_t.closure_margin
    assert abs(float(delta_t[2]) + 0.08) <= 0.04


def test_closure_flat_surface_never_fires():
    """Empty maps (unexplored space): the likelihood surface is flat, the
    margin gate must keep the correction at exactly zero."""
    m = _maze()
    cfg = _cfg(m, num_particles=4, closure=True)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 16)),
                         jnp.float32)
    lo = jnp.zeros((4, cfg.mapping.height, cfg.mapping.width), jnp.float32)
    w = jnp.full((4,), 0.25, jnp.float32)
    delta, gain = slam.closure_correction(
        lo, w, jnp.asarray([1.25, 1.25, 0.0]),
        jnp.full((16,), 0.6, jnp.float32), angles, jnp.ones((16,)), cfg)
    assert np.allclose(np.asarray(delta), 0.0)
    assert float(gain) < cfg.closure_margin


def test_closure_rigid_apply_preserves_spread():
    """_apply_rigid_delta is a rigid transform: pairwise distances and
    relative headings survive; delta = 0 is the identity."""
    rng = np.random.RandomState(0)
    poses = jnp.asarray(rng.uniform(0, 4, size=(32, 3)), jnp.float32)
    mean = jnp.asarray([2.0, 2.0, 0.3], jnp.float32)
    ident = slam._apply_rigid_delta(poses, mean, jnp.zeros(3, jnp.float32))
    np.testing.assert_allclose(np.asarray(ident)[:, :2],
                               np.asarray(poses)[:, :2], atol=1e-6)
    delta = jnp.asarray([0.2, -0.1, 0.4], jnp.float32)
    out = np.asarray(slam._apply_rigid_delta(poses, mean, delta))
    p = np.asarray(poses)
    d_before = np.hypot(p[:, None, 0] - p[None, :, 0],
                        p[:, None, 1] - p[None, :, 1])
    d_after = np.hypot(out[:, None, 0] - out[None, :, 0],
                       out[:, None, 1] - out[None, :, 1])
    np.testing.assert_allclose(d_after, d_before, atol=1e-4)
    dt = (out[:, 2] - p[:, 2] + np.pi) % (2 * np.pi) - np.pi
    np.testing.assert_allclose(dt, 0.4, atol=1e-5)


def test_closure_off_and_huge_margin_identical():
    """closure=False and closure with an unreachable margin produce the
    SAME episode (the gate is the only source of pose change)."""
    m = _maze()
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 12)),
                         jnp.float32)
    cfg_off = _cfg(m, num_particles=8, keyframe_trans=0.1,
                   keyframe_rot=0.35)
    cfg_gate = dataclasses.replace(cfg_off, closure=True,
                                   closure_margin=1e9)
    start = (1.25, 1.25, 0.0)
    fcfg = FilterConfig()
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(3), m, fcfg, np.asarray(angles), 60,
        start_pose=start, slip_noise=0.05, explore=True)
    _, est_off = slam.run_slam_episode(jax.random.PRNGKey(9), enc, scans,
                                       angles, cfg_off, start)
    _, est_gate = slam.run_slam_episode(jax.random.PRNGKey(9), enc, scans,
                                        angles, cfg_gate, start)
    np.testing.assert_allclose(np.asarray(est_off), np.asarray(est_gate),
                               atol=1e-6)


def test_log_evidence_accumulates_and_prefers_consistency():
    """SLAMState.log_evidence is the SIR marginal-likelihood estimate:
    it accumulates every tick, and an episode whose scans are CONSISTENT
    (generated by the true maze) accumulates more evidence than the same
    filter fed shuffled (inconsistent) scans."""
    m = _maze()
    cfg = _cfg(m, num_particles=16, keyframe_trans=0.15, keyframe_rot=0.5)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 12)),
                         jnp.float32)
    fcfg = FilterConfig()
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(5), m, fcfg, np.asarray(angles), 60,
        start_pose=(1.25, 1.25, 0.0), slip_noise=0.03, explore=True)
    fin, _ = slam.run_slam_episode(jax.random.PRNGKey(2), enc, scans,
                                   angles, cfg, (1.25, 1.25, 0.0))
    ev_good = float(fin.log_evidence)
    assert np.isfinite(ev_good)
    shuffled = jnp.asarray(np.asarray(scans)[::-1].copy())
    fin_bad, _ = slam.run_slam_episode(jax.random.PRNGKey(2), enc,
                                       shuffled, angles, cfg,
                                       (1.25, 1.25, 0.0))
    assert ev_good > float(fin_bad.log_evidence)


def test_run_slam_replicas_selects_argmax_evidence():
    m = _maze()
    cfg = _cfg(m, num_particles=8, keyframe_trans=0.15, keyframe_rot=0.5)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 12)),
                         jnp.float32)
    fcfg = FilterConfig()
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(9), m, fcfg, np.asarray(angles), 40,
        start_pose=(1.25, 1.25, 0.0), slip_noise=0.05, explore=True)
    key = jax.random.PRNGKey(4)
    final, est, info = slam.run_slam_replicas(
        key, enc, scans, angles, cfg, (1.25, 1.25, 0.0), replicas=3)
    evs = np.asarray(info["log_evidence"])
    assert evs.shape == (3,) and np.isfinite(evs).all()
    chosen = int(info["chosen"])
    assert chosen == int(np.argmax(evs))
    # The returned final/est ARE the winning replica's.
    keys = jax.random.split(key, 3)
    fin_c, est_c = slam.run_slam_episode(
        keys[chosen], enc, scans, angles, cfg, (1.25, 1.25, 0.0))
    np.testing.assert_allclose(np.asarray(est), np.asarray(est_c),
                               atol=1e-6)
    np.testing.assert_allclose(float(final.log_evidence),
                               float(fin_c.log_evidence), rtol=1e-6)


def test_chunked_slam_episode_bit_identical():
    """run_slam_episode_chunked must reproduce the one-scan episode
    exactly (RNG rides the carried state; chunking only splits the
    dispatches)."""
    m = _maze()
    cfg = _cfg(m, num_particles=8, keyframe_trans=0.15, keyframe_rot=0.5)
    angles = jnp.asarray(np.deg2rad(np.linspace(-118, 118, 12)),
                         jnp.float32)
    fcfg = FilterConfig()
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(6), m, fcfg, np.asarray(angles), 30,
        start_pose=(1.25, 1.25, 0.0), slip_noise=0.05, explore=True)
    key = jax.random.PRNGKey(8)
    f_full, est_full = slam.run_slam_episode(
        key, enc, scans, angles, cfg, (1.25, 1.25, 0.0))
    f_ch, est_ch = slam.run_slam_episode_chunked(
        key, enc, scans, angles, cfg, (1.25, 1.25, 0.0), tick_chunk=7)
    np.testing.assert_array_equal(np.asarray(est_full),
                                  np.asarray(est_ch))
    np.testing.assert_array_equal(np.asarray(f_full.logodds),
                                  np.asarray(f_ch.logodds))
    np.testing.assert_array_equal(np.asarray(f_full.log_evidence),
                                  np.asarray(f_ch.log_evidence))
