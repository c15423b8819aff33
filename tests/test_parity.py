"""Numerical parity vs a C++-faithful NumPy oracle (SURVEY.md §4).

The oracle (tests/oracle.py) transcribes the reference's sequential math
(Gaussian LUT + lerp, trunc worldToMap, 9-point stencil, 0.1 m march,
negated beams, likelihood mixture).  The vectorized JAX filter must match
it to float tolerance on identical inputs.
"""
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import motion, resample, sensor

from oracle import Oracle, diff_drive_decompose

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


@pytest.fixture(scope="module")
def setup():
    m = from_map_file(MAP_PATH)
    oracle = Oracle(np.asarray(m.occ))
    cfg = SensorModelConfig(ray_mode="fixed", lookup_mode="gather")
    angles = np.deg2rad(np.linspace(-115, 115, 16)).astype(np.float32)
    return m, oracle, cfg, angles


def test_beam_weights_match_oracle(setup):
    m, oracle, cfg, angles = setup
    parts = np.asarray(resample.sample_uniform_particles(
        jax.random.PRNGKey(3), m, 256))
    scan = sensor.simulate_scan(
        m, jnp.array([2.05, 2.05, 0.4]), angles, cfg)
    ranges = np.asarray(scan.ranges)
    got = np.asarray(sensor.beam_weights(m, jnp.asarray(parts), scan, cfg))
    want = oracle.compute_weights(parts.astype(np.float64), angles, ranges)
    # Exact-Gaussian vs LUT-with-lerp agree to ~1e-7 relative; f32 compute
    # gives a few 1e-4 absolute.
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # Zero/non-zero (validity gating) must agree exactly.
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_raycast_matches_oracle(setup):
    m, oracle, cfg, _ = setup
    rng = np.random.default_rng(1)
    from montecarlolocalisation.models.raycast import raycast

    xs = rng.uniform(0.2, 4.6, 128)
    ys = rng.uniform(0.2, 4.6, 128)
    ths = rng.uniform(-np.pi, np.pi, 128)
    got = np.asarray(raycast(m, jnp.asarray(xs, jnp.float32),
                             jnp.asarray(ys, jnp.float32),
                             jnp.asarray(ths, jnp.float32), cfg))
    want = np.array([oracle.raycast(x, y, t)
                     for x, y, t in zip(xs, ys, ths)])
    # f32 vs f64 step accumulation can flip a boundary sample.
    agree = np.isclose(got, want, atol=1e-5)
    assert agree.mean() > 0.97
    if (~agree).any():
        assert np.abs(got[~agree] - want[~agree]).max() <= 0.1 + 1e-6


def test_validity_matches_oracle(setup):
    m, oracle, cfg, _ = setup
    from montecarlolocalisation.maps.grid import is_valid_pos

    rng = np.random.default_rng(2)
    xs = rng.uniform(-0.2, 5.1, 512)
    ys = rng.uniform(-0.2, 5.1, 512)
    got = np.asarray(is_valid_pos(m, jnp.asarray(xs, jnp.float32),
                                  jnp.asarray(ys, jnp.float32)))
    want = np.array([oracle.is_valid_pos(x, y) for x, y in zip(xs, ys)])
    assert (got == want).mean() > 0.995  # float pixel-tie boundary cases


def test_motion_decomposition_matches_oracle():
    st = motion.OdometryState.zero()
    cases = [((3.0, 5.0)), ((10.0, 4.0)), ((-2.0, 2.0)), ((7.7, 7.7))]
    pose = (0.0, 0.0, 0.0)
    enc_prev = (0.0, 0.0)
    for enc in cases:
        cfg = motion.MotionModelConfig() if hasattr(motion, "MotionModelConfig") \
            else None
        from montecarlolocalisation.config import MotionModelConfig
        cfg = MotionModelConfig()
        new, rot1, trans, rot2 = motion.diff_drive_update(
            st, jnp.float32(enc[0]), jnp.float32(enc[1]), cfg)
        (ox, oy, oth), orot1, otrans, orot2 = diff_drive_decompose(
            pose, enc_prev, enc)
        assert float(new.x) == pytest.approx(ox, abs=1e-5)
        assert float(new.y) == pytest.approx(oy, abs=1e-5)
        assert float(new.theta) == pytest.approx(oth, abs=1e-5)
        assert float(rot1) == pytest.approx(orot1, abs=1e-5)
        assert float(trans) == pytest.approx(otrans, abs=1e-5)
        assert float(rot2) == pytest.approx(orot2, abs=1e-5)


def test_gauss_exact_vs_lut_error_bound():
    from oracle import GaussianLUT

    lut = GaussianLUT()
    cfg = SensorModelConfig()
    diffs = np.linspace(0, 1.1, 2003)
    exact = np.asarray(sensor.gauss_pdf(jnp.asarray(diffs, jnp.float32), cfg))
    table = np.array([lut.get(d) for d in diffs])
    np.testing.assert_allclose(exact, table, atol=5e-5)


def test_episode_posterior_statistics_match_oracle(setup):
    """VERDICT r3 #7: the oracle as a FULL filter over an episode.

    Runs the C++-faithful sequential filter (oracle.OracleFilter — the
    executeParticleFilter tick loop, monte_carlo.cpp:1025-1098) and the
    JAX mcl_step on IDENTICAL inputs from a tracking start, and compares
    ENSEMBLE posterior statistics over independent seeds — per-draw RNG
    streams cannot match (threefry vs PCG64), and single trajectories are
    chaotic (the reference's conf_alpha_fast=2.0 quirk makes w_fast an
    oscillator whose injection bursts churn ~10% of the cloud), but the
    oscillation PHASE is input-driven, so per-tick seed-averaged
    statistics are stable and must agree: cloud-mean trajectory, cloud
    spread (injection/jitter regime), per-tick injection counts (the
    w_slow/w_fast bookkeeping + cap), and confidence.  Any stage-semantics
    drift shifts one of these trajectories and fails here.
    """
    from oracle import OracleFilter
    from montecarlolocalisation.config import ResampleConfig
    from montecarlolocalisation.models import filter as mcl
    from montecarlolocalisation.sim import robot

    m, oracle, _, _ = setup
    n, ticks, seeds = 384, 24, 6
    start = (1.25, 1.25, 0.0)
    angles = np.deg2rad(np.linspace(-115, 115, 16)).astype(np.float32)
    cfg = FilterConfig(
        num_particles=n,
        sensor=SensorModelConfig(ray_mode="fixed", lookup_mode="gather"),
        resample=ResampleConfig(method="multinomial",
                                multinomial_impl="exact"))
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(5), m, cfg, angles, ticks, start_pose=start)
    enc, scans, truth = map(np.asarray, (enc, scans, truth))

    def run_jax(seed):
        state = mcl.init_tracking_state(jax.random.PRNGKey(seed), m, cfg,
                                        start)
        step = jax.jit(
            lambda st, el, er, sc: mcl.mcl_step(st, el, er, sc, m, cfg))
        mean, spread, conf, ninj = [], [], [], []
        for t in range(ticks):
            sc = sensor.Scan(angles=jnp.asarray(angles),
                             ranges=jnp.asarray(scans[t]),
                             mask=jnp.ones((angles.size,), bool))
            state, out = step(state, jnp.float32(enc[t, 0]),
                              jnp.float32(enc[t, 1]), sc)
            xy = np.asarray(state.particles)[:, :2]
            mean.append(xy.mean(axis=0))
            spread.append(float(np.sqrt(
                ((xy - xy.mean(axis=0)) ** 2).sum(axis=1).mean())))
            conf.append(float(state.confidence))
            ninj.append(int(out.n_injected))
        return tuple(map(np.asarray, (mean, spread, conf, ninj)))

    def run_oracle(seed):
        of = OracleFilter(oracle, n, seed=seed, start_pose=start)
        mean, spread, conf, ninj = [], [], [], []
        for t in range(ticks):
            rec = of.tick(float(enc[t, 0]), float(enc[t, 1]), angles,
                          scans[t])
            mean.append(rec["mean"])
            spread.append(rec["spread"])
            conf.append(rec["confidence"])
            ninj.append(rec["n_injected"])
        return tuple(map(np.asarray, (mean, spread, conf, ninj)))

    j = [run_jax(100 + s) for s in range(seeds)]
    o = [run_oracle(200 + s) for s in range(seeds)]
    jm, js, jc, ji = (np.mean([r[k] for r in j], axis=0) for k in range(4))
    om, os_, oc, oi = (np.mean([r[k] for r in o], axis=0) for k in range(4))

    # Ensemble cloud-mean trajectories agree.
    d = np.hypot(jm[:, 0] - om[:, 0], jm[:, 1] - om[:, 1])
    assert d.mean() < 0.2, f"ens cloud-mean gap {d.mean():.3f} m"
    # Spread trajectories agree in scale (jitter + injection regime).
    rs = js[3:].mean() / os_[3:].mean()
    assert 0.6 < rs < 1.5, f"ens spread ratio {rs:.2f}"
    # Injection bookkeeping (w_slow/w_fast dual-timescale update incl. the
    # alpha_fast=2 oscillator + first-come cap): both filters must inject,
    # at comparable volume, on the SAME ticks — the oscillation phase is
    # input-driven, so the burst ticks are a deterministic fingerprint of
    # the bookkeeping semantics.
    assert ji.sum() > 0 and oi.sum() > 0, "oscillator quirk missing"
    rel = abs(ji.sum() - oi.sum()) / max(oi.sum(), 1.0)
    assert rel < 0.5, f"total injected {ji.sum():.0f} vs {oi.sum():.0f}"
    jb, ob = ji > 0.5, oi > 0.5
    overlap = (jb & ob).sum() / max((jb | ob).sum(), 1)
    assert overlap >= 0.6, f"injection-phase overlap {overlap:.2f}"
    # Confidence trajectories agree on average.
    assert abs(jc.mean() - oc.mean()) < 0.12, \
        f"confidence {jc.mean():.2f} vs {oc.mean():.2f}"
