"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

Validates that the particle-axis-sharded step (psum/all_gather resampling,
distributed k-means) matches the single-device filter statistically, and
that the 2D episode x particle mesh compiles and runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import filter as mcl
from montecarlolocalisation.models import sensor
from montecarlolocalisation.parallel import distributed as dist

import os.path as osp

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

CFG = FilterConfig(num_particles=1024,
                   sensor=SensorModelConfig(ray_mode="fixed"))
ANGLES = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def maze():
    return from_map_file(MAP_PATH)


@pytest.fixture(scope="module")
def scan(maze):
    return sensor.simulate_scan(
        maze, jnp.array([1.25, 1.25, 0.0]), ANGLES, CFG.sensor)


def test_sharded_step_runs_and_is_finite(maze, scan):
    mesh = dist.make_mesh(n_particle_shards=8)
    state = mcl.init_state(jax.random.PRNGKey(0), maze, CFG)
    state = dist.shard_state(state, mesh)
    step = dist.make_sharded_step(mesh, maze, CFG)
    st2, out = step(state, jnp.float32(0.1), jnp.float32(0.12), scan)
    assert st2.particles.shape == (1024, 3)
    assert np.isfinite(np.asarray(st2.particles)).all()
    assert np.isfinite(float(st2.confidence))
    # Weights sum to 1 after resampling (1/N each).
    np.testing.assert_allclose(float(jnp.sum(st2.weights)), 1.0, rtol=1e-5)


def test_sharded_matches_single_device_statistically(maze, scan):
    """Same inputs: sharded and local steps must produce statistically
    equivalent posteriors (RNG streams differ by construction)."""
    mesh = dist.make_mesh(n_particle_shards=8)
    state0 = mcl.init_state(jax.random.PRNGKey(0), maze, CFG)

    local_step = jax.jit(functools.partial(mcl.mcl_step, m=maze, cfg=CFG))
    st_l = state0
    sharded = dist.shard_state(state0, mesh)
    step = dist.make_sharded_step(mesh, maze, CFG)

    for i in range(3):
        enc = jnp.float32(0.05 * i)
        st_l, _ = local_step(st_l, enc, enc, scan)
        sharded, _ = step(sharded, enc, enc, scan)

    pl = np.asarray(st_l.particles)
    ps = np.asarray(sharded.particles)
    # Posterior mass concentrates in the same region: compare weighted
    # centroids of the surviving clouds.
    assert abs(pl[:, 0].mean() - ps[:, 0].mean()) < 0.4
    assert abs(pl[:, 1].mean() - ps[:, 1].mean()) < 0.4
    assert abs(float(st_l.confidence) - float(sharded.confidence)) < 0.5


def test_sharded_injection_cap_is_global(maze):
    """Force heavy injection: the global cap (200 lost-regime) must hold
    across shards."""
    mesh = dist.make_mesh(n_particle_shards=8)
    state = mcl.init_state(jax.random.PRNGKey(1), maze, CFG)
    # Degenerate scan far from anything -> tiny weights after good history.
    bad_scan = sensor.Scan(
        angles=jnp.asarray(ANGLES),
        ranges=jnp.full((len(ANGLES),), 0.123, jnp.float32),
        mask=jnp.ones((len(ANGLES),), dtype=bool))
    from montecarlolocalisation.models import resample as rs
    state = mcl.MCLState(
        particles=state.particles, weights=state.weights, odom=state.odom,
        inj=rs.InjectionState(w_slow=jnp.float32(10.0),
                              w_fast=jnp.float32(10.0)),
        confidence=state.confidence, was_lost=jnp.bool_(True),
        cluster_threshold=state.cluster_threshold,
        confident_threshold=state.confident_threshold,
        best_pose=state.best_pose, key=state.key)
    state = dist.shard_state(state, mesh)
    step = dist.make_sharded_step(mesh, maze, CFG)
    _, out = step(state, jnp.float32(0.0), jnp.float32(0.0), bad_scan)
    n_inj = int(out.n_injected)
    assert 0 < n_inj <= 200, f"global injection cap violated: {n_inj}"


def test_sharded_systematic_resampling(maze, scan):
    """Systematic mode on the mesh: global stratified indices sliced per
    shard must reproduce the single-device expansion distribution."""
    from montecarlolocalisation.config import ResampleConfig

    cfg = FilterConfig(
        num_particles=1024,
        sensor=SensorModelConfig(ray_mode="fixed"),
        resample=ResampleConfig(method="systematic"))
    mesh = dist.make_mesh(n_particle_shards=8)
    state = mcl.init_state(jax.random.PRNGKey(3), maze, cfg)
    state = dist.shard_state(state, mesh)
    step = dist.make_sharded_step(mesh, maze, cfg)
    st = state
    for i in range(3):
        enc = jnp.float32(0.05 * i)
        st, out = step(st, enc, enc, scan)
    assert np.isfinite(np.asarray(st.particles)).all()
    np.testing.assert_allclose(float(jnp.sum(st.weights)), 1.0, rtol=1e-5)
    # Surviving cloud concentrates where the weights were (not uniform).
    spread = np.asarray(st.particles)[:, :2].std(axis=0)
    assert (spread < 1.6).all()


def test_sharded_ess_gated_schedule(maze, scan):
    """ESS gating on the mesh: the gate predicate is built from psums, so
    all shards take the same branch; skipped ticks carry non-uniform
    normalized weights, and the weighted confidence stays finite."""
    from montecarlolocalisation.config import ResampleConfig

    cfg = FilterConfig(
        num_particles=1024,
        sensor=SensorModelConfig(ray_mode="fixed"),
        resample=ResampleConfig(method="systematic", ess_threshold=0.5))
    mesh = dist.make_mesh(n_particle_shards=8)
    state = mcl.init_state(jax.random.PRNGKey(3), maze, cfg)
    state = dist.shard_state(state, mesh)
    step = dist.make_sharded_step(mesh, maze, cfg)
    st = state
    for i in range(4):
        enc = jnp.float32(0.05 * i)
        st, out = step(st, enc, enc, scan)
        # Carried weights always normalize to 1 globally (uniform 1/N
        # after a pass, combined posterior weights on skipped ticks).
        np.testing.assert_allclose(float(jnp.sum(st.weights)), 1.0,
                                   rtol=1e-4)
    assert np.isfinite(np.asarray(st.particles)).all()
    assert np.isfinite(float(st.confidence))


def test_sharded_ess_matches_local_weights(maze, scan):
    """One ESS-gated tick: global weight sum and ESS bookkeeping on the
    mesh match the single-device path closely (same particles forced in)."""
    import dataclasses

    from montecarlolocalisation.config import ResampleConfig

    cfg = FilterConfig(
        num_particles=1024,
        sensor=SensorModelConfig(ray_mode="fixed"),
        motion=dataclasses.replace(FilterConfig().motion,
                                   alpha_1=0.0, alpha_2=0.0,
                                   alpha_3=0.0, alpha_4=0.0),
        resample=ResampleConfig(method="systematic", ess_threshold=0.05))
    state0 = mcl.init_state(jax.random.PRNGKey(5), maze, cfg)
    # Zero odometry + zero noise alphas: motion is a no-op, so both paths
    # weight THE SAME particle set; with a tiny tau and fresh uniform
    # weights the tick SKIPS the pass on both paths, making the carried
    # normalized weights directly comparable.
    mesh = dist.make_mesh(n_particle_shards=8)
    local_step = jax.jit(functools.partial(mcl.mcl_step, m=maze, cfg=cfg))
    st_l, _ = local_step(state0, jnp.float32(0.0), jnp.float32(0.0), scan)
    sharded = dist.shard_state(state0, mesh)
    step = dist.make_sharded_step(mesh, maze, cfg)
    st_s, _ = step(sharded, jnp.float32(0.0), jnp.float32(0.0), scan)
    np.testing.assert_allclose(np.asarray(st_s.weights),
                               np.asarray(st_l.weights), rtol=1e-4)


def test_sharded_refinement_runs(maze, scan):
    """Refinement is per-particle: the sharded step refines local shards
    (no collectives) and stays finite; likelihood must not decrease."""
    from montecarlolocalisation.config import RefineConfig

    cfg = FilterConfig(
        num_particles=1024,
        sensor=SensorModelConfig(ray_mode="fixed"),
        refine=RefineConfig(iters=1))
    mesh = dist.make_mesh(n_particle_shards=8)
    state = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    state = dist.shard_state(state, mesh)
    step = dist.make_sharded_step(mesh, maze, cfg)
    st, out = step(state, jnp.float32(0.0), jnp.float32(0.0), scan)
    assert np.isfinite(np.asarray(st.particles)).all()
    assert np.isfinite(float(st.confidence))


def test_batched_2d_mesh_step(maze):
    """Episode x particle 2D mesh: the dryrun_multichip configuration."""
    mesh = dist.make_mesh(n_particle_shards=4, n_episode_shards=2)
    cfg = FilterConfig(num_particles=256,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    n_episodes = 4
    state = dist.init_batched_state(jax.random.PRNGKey(0), maze, cfg,
                                    n_episodes)
    ranges = jnp.full((n_episodes, len(ANGLES)), 0.7, dtype=jnp.float32)
    ep_sh = NamedSharding(mesh, P("episode"))
    state = dist.shard_state(state, mesh, episode_axis="episode")
    enc = jax.device_put(jnp.full((n_episodes,), 0.3, jnp.float32), ep_sh)
    sc = sensor.Scan(angles=jnp.asarray(ANGLES),
                     ranges=jax.device_put(ranges, ep_sh),
                     mask=jnp.ones((len(ANGLES),), dtype=bool))
    step = dist.make_sharded_step_batched(mesh, maze, cfg)
    st2, out = step(state, enc, enc, sc)
    assert st2.particles.shape == (n_episodes, 256, 3)
    assert np.isfinite(np.asarray(st2.particles)).all()
    assert out.exact_pose.shape == (n_episodes, 3)


def test_graft_entry_dryrun():
    """The driver's dryrun_multichip must work on the virtual mesh."""
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(
        "graft_entry", osp.join(osp.dirname(__file__), "..",
                                "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_episode_batch_sharded_over_mesh(maze):
    """run_episode_batch with a mesh shards the episode axis (pure DP)."""
    from montecarlolocalisation.parallel import episodes

    mesh = dist.make_mesh(n_particle_shards=1, n_episode_shards=8)
    cfg = FilterConfig(num_particles=64,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    enc, scans, truth = episodes.simulate_episode_batch(
        jax.random.PRNGKey(0), maze, cfg, ANGLES, num_ticks=8, batch=8,
        start_pose=(2.05, 2.05, 0.0))
    final, outs = episodes.run_episode_batch(
        jax.random.PRNGKey(1), maze, cfg, enc, scans, ANGLES, mesh=mesh)
    assert final.particles.shape == (8, 64, 3)
    assert np.isfinite(np.asarray(final.particles)).all()


# ---------------------------------------------------------------------------
# Ring offspring exchange (round-4: O(N/P) per-chip resampling)
# ---------------------------------------------------------------------------

def _adversarial_weights(key, n, trial):
    """Weight patterns that stress shard imbalance: heavy concentration,
    half-zero shards, all mass on one particle."""
    w = jax.random.uniform(key, (n,)) ** jnp.float32(8.0 if trial % 2 else 1.0)
    if trial % 3 == 0:
        w = w.at[: n // 2].set(0.0)
    if trial == 5:
        w = jnp.zeros((n,)).at[7].set(1.0)
    if trial == 7:
        w = jnp.zeros((n,)).at[n - 1].set(1.0)
    return w / jnp.sum(w)


def test_ring_systematic_bit_matches_single_device():
    """The ring exchange must reproduce particles[systematic_indices(cdf)]
    exactly, including degenerate all-mass-on-one-shard weight patterns
    (every output block then assembles from a remote source block)."""
    from montecarlolocalisation.models import resample as rs

    mesh = dist.make_mesh(n_particle_shards=8)
    n = 512
    key = jax.random.PRNGKey(11)
    for trial in range(8):
        key, k_w, k_p, k_u = jax.random.split(key, 4)
        norm = _adversarial_weights(k_w, n, trial)
        parts = jax.random.normal(k_p, (n, 3))
        u0 = jax.random.uniform(k_u, ())
        want = parts[rs.systematic_indices(jnp.cumsum(norm), u0)]

        fn = jax.jit(jax.shard_map(
            functools.partial(dist._ring_systematic_draw, u0=u0,
                              axis_name="particle"),
            mesh=mesh, in_specs=(P("particle"), P("particle")),
            out_specs=P("particle")))
        got = fn(parts, norm)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_ring_multinomial_semantics_and_frequencies():
    """Ring multinomial: every drawn row must be parts[searchsorted(cdf, r)]
    for its (globally sorted) uniform r — verified against the host
    searchsorted up to fp block-boundary slots — and draw frequencies must
    track the weights."""
    mesh = dist.make_mesh(n_particle_shards=8)
    n = 2048
    key = jax.random.PRNGKey(23)
    k_w, k_p, k_d = jax.random.split(key, 3)
    norm = _adversarial_weights(k_w, n, 1)
    parts = (jnp.arange(n, dtype=jnp.float32)[:, None]
             * jnp.ones((1, 3)))  # row i == [i, i, i]: read idx off values

    fn = jax.jit(jax.shard_map(
        functools.partial(dist._ring_multinomial_draw, k_d,
                          axis_name="particle"),
        mesh=mesh, in_specs=(P("particle"), P("particle")),
        out_specs=P("particle")))
    got = np.asarray(fn(parts, norm))
    idx = got[:, 0].astype(np.int64)
    freq = np.bincount(idx, minlength=n) / n
    # Frequencies track weights (multinomial noise ~ sqrt(w/n)).
    assert np.abs(freq - np.asarray(norm)).max() < 0.02
    # Top-weight particle is drawn with roughly its weight share.
    top = int(np.argmax(np.asarray(norm)))
    assert freq[top] > 0.5 * float(norm[top])


def _inner_jaxprs(eqn):
    """All sub-jaxprs of an eqn (jit/cond/scan/shard_map params)."""
    out = []
    for param in eqn.params.values():
        candidates = param if isinstance(param, (list, tuple)) else (param,)
        for p in candidates:
            ij = getattr(p, "jaxpr", None)
            if ij is not None:
                out.append(ij)
            elif hasattr(p, "eqns"):     # a raw Jaxpr
                out.append(p)
    return out


def _walk_jaxpr_shapes(jaxpr, found, pred, inside_shard_map=False):
    """Record eqn outputs matching `pred` that live INSIDE a shard_map
    sub-jaxpr (where all shapes are per-shard)."""
    for eqn in jaxpr.eqns:
        if inside_shard_map:
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if aval is not None and pred(aval):
                    found.append((str(eqn.primitive), str(aval)))
        inner_flag = inside_shard_map or "shard_map" in str(eqn.primitive)
        for ij in _inner_jaxprs(eqn):
            _walk_jaxpr_shapes(ij, found, pred, inner_flag)


def test_ring_step_has_no_global_cloud_intermediate(maze, scan):
    """Memory-scalability assertion: inside the shard_map'd step (where all
    shapes are per-shard), NO intermediate may have the global particle
    count — the ring exchange keeps every array O(N/P).  The legacy
    allgather mode must FAIL this check (sanity that the walker sees it)."""
    from montecarlolocalisation.config import ResampleConfig

    n_global = 1024  # 8 shards x 128 local
    mesh = dist.make_mesh(n_particle_shards=8)

    def trace(exchange, method):
        cfg = FilterConfig(
            num_particles=n_global,
            sensor=SensorModelConfig(ray_mode="fixed"),
            resample=ResampleConfig(method=method,
                                    sharded_exchange=exchange))
        state = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
        state = dist.shard_state(state, mesh)
        step = dist.make_sharded_step(mesh, maze, cfg)
        jaxpr = jax.make_jaxpr(
            lambda st: step(st, jnp.float32(0.1), jnp.float32(0.1), scan)
        )(state)
        found = []
        # Global-sized arrays are legal OUTSIDE shard_map (the step's own
        # in/outputs); inside, every shape is local, so any (n_global, ...)
        # eqn output within a shard_map sub-jaxpr is a replicated cloud.
        _walk_jaxpr_shapes(
            jaxpr.jaxpr, found,
            lambda aval: getattr(aval, "shape", ())[:1] == (n_global,))
        return found

    assert trace("ring", "systematic") == []
    assert trace("ring", "multinomial") == []
    # Sanity: the walker must detect the legacy replicated cloud.
    assert len(trace("allgather", "systematic")) > 0


def test_ring_matches_allgather_full_step(maze, scan):
    """Full resample_sharded parity: ring and allgather systematic modes
    share every RNG stream (jitter, injection, u0), and the ring idx map is
    bit-exact, so the complete sharded step must produce IDENTICAL state."""
    import dataclasses as dc

    from montecarlolocalisation.config import ResampleConfig

    mesh = dist.make_mesh(n_particle_shards=8)

    def run(exchange):
        cfg = FilterConfig(
            num_particles=1024,
            sensor=SensorModelConfig(ray_mode="fixed"),
            resample=ResampleConfig(method="systematic",
                                    sharded_exchange=exchange))
        state = mcl.init_state(jax.random.PRNGKey(7), maze, cfg)
        state = dist.shard_state(state, mesh)
        step = dist.make_sharded_step(mesh, maze, cfg)
        st = state
        for i in range(3):
            enc = jnp.float32(0.05 * i)
            st, out = step(st, enc, enc, scan)
        return st

    st_ring = run("ring")
    st_ag = run("allgather")
    np.testing.assert_array_equal(np.asarray(st_ring.particles),
                                  np.asarray(st_ag.particles))
    np.testing.assert_array_equal(np.asarray(st_ring.weights),
                                  np.asarray(st_ag.weights))
    assert float(st_ring.confidence) == float(st_ag.confidence)


def test_pallas_weight_kernel_composes_with_shard_map(maze, scan):
    """The fused beam-weight kernel traced together with shard_map (the
    particle-sharded step runs it per shard on the GPU): per-shard kernel
    weights, in the Pallas interpreter, must match the dense path."""
    mesh = dist.make_mesh(n_particle_shards=8)
    cfg = SensorModelConfig(ray_mode="analytic")
    parts = mcl.init_state(jax.random.PRNGKey(2), maze,
                           FilterConfig(num_particles=1024)).particles

    def weights_sharded(fn):
        def body(p, angles, ranges, mask):
            return fn(p, sensor.Scan(angles=angles, ranges=ranges, mask=mask))
        return np.asarray(jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("particle"), P(), P(), P()),
            out_specs=P("particle"), check_vma=False))(
            parts, scan.angles, scan.ranges, scan.mask))

    wk = weights_sharded(lambda p, sc: sensor.beam_weights_fused(
        maze, p, sc, cfg, interpret=True))
    wd = weights_sharded(lambda p, sc: sensor._beam_weights_dense(
        maze, p, sc, cfg, maze.resolution, "gather"))
    close = np.isclose(wk, wd, rtol=2e-4, atol=1e-6)
    assert close.mean() > 0.995    # analytic pixel-boundary ties
    np.testing.assert_allclose(wk[close], wd[close], rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Particle-sharded SLAM (poses + per-particle maps on the mesh)
# ---------------------------------------------------------------------------
def _slam_cfg(maze, **kw):
    from montecarlolocalisation.config import MappingConfig, SLAMConfig

    mc = MappingConfig(height=maze.height, width=maze.width,
                       resolution=float(maze.resolution),
                       origin_x=float(maze.origin_x),
                       origin_y=float(maze.origin_y))
    return SLAMConfig(mapping=mc, sensor=CFG.sensor, **kw)


def test_sharded_slam_step_runs_and_normalizes(maze, scan):
    from montecarlolocalisation.models import slam

    cfg = _slam_cfg(maze, num_particles=32)   # 4 per shard
    mesh = dist.make_mesh(n_particle_shards=8)
    st = slam.init_slam(jax.random.PRNGKey(0), (1.25, 1.25, 0.0), cfg)
    st = dist.shard_slam_state(st, mesh)
    step = dist.make_sharded_slam_step(mesh, cfg)
    st2, info = step(st, jnp.float32(0.3), jnp.float32(0.32),
                     scan.ranges, jnp.asarray(ANGLES),
                     jnp.ones_like(scan.ranges))
    assert st2.poses.shape == (32, 3)
    assert st2.logodds.shape == (32, maze.height, maze.width)
    np.testing.assert_allclose(float(jnp.sum(st2.weights)), 1.0, rtol=1e-5)
    assert np.isfinite(np.asarray(info["pose"])).all()
    # Maps accumulated evidence locally (no collective needed to paint).
    assert float(jnp.abs(st2.logodds).sum()) > 0.0


def test_sharded_slam_resample_maps_ride_with_poses(maze, scan):
    """Force a resample and verify each surviving (pose, map) pair stays
    consistent through the RING payload exchange: particle i's map is
    filled with the constant i and its pose x = 10 + i, so any cross-shard
    slot assembly mismatch shows up as map != pose - 10."""
    import dataclasses as dc

    from montecarlolocalisation.models import slam

    cfg = _slam_cfg(maze, num_particles=32, ess_threshold=1.1)  # always
    mesh = dist.make_mesh(n_particle_shards=8)
    st = slam.init_slam(jax.random.PRNGKey(1), (1.25, 1.25, 0.0), cfg)
    ids = jnp.arange(32, dtype=jnp.float32)
    st = dc.replace(
        st,
        poses=jnp.stack([10.0 + ids, jnp.full((32,), 1.25),
                         jnp.zeros((32,))], axis=-1),
        # Scaled below MappingConfig.clamp (8.0): update_map clamps the
        # grid even on a zero-deposit tick.
        logodds=jnp.broadcast_to(
            ids[:, None, None] / 8.0, (32, maze.height, maze.width)),
        # Skewed weights so the draw repeats some sources across shards.
        weights=(ids + 1.0) ** 3 / jnp.sum((ids + 1.0) ** 3))
    st = dist.shard_slam_state(st, mesh)
    # Zero motion noise propagation keeps x identifiable: drive encoders
    # by zero so poses stay put (alphas scale rot/trans = 0 -> no noise).
    step = dist.make_sharded_slam_step(mesh, cfg)
    st2, info = step(st, jnp.float32(0.0), jnp.float32(0.0),
                     scan.ranges, jnp.asarray(ANGLES),
                     jnp.zeros_like(scan.ranges))   # masked scan: no weight
    assert bool(info["resampled"])
    poses = np.asarray(st2.poses)
    # The map update painted nothing (all beams masked), so map cells
    # still hold the source id.
    maps = np.asarray(st2.logodds)
    src = poses[:, 0] - 10.0
    np.testing.assert_allclose(8.0 * maps[:, 0, 0], src, atol=1e-4)
    np.testing.assert_allclose(8.0 * maps[:, 5, 7], src, atol=1e-4)
    # Skewed weights concentrate offspring on high-id sources.
    assert src.mean() > 20.0
