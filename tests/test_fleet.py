"""Fleet serving (io/fleet.MCLFleetServer): R filters per batched step.

Parity anchor: robot r of the fleet must produce EXACTLY the trajectory a
standalone filter produces from the same init key and sensor stream — the
fleet is pure data parallelism (vmap), no cross-robot coupling.
"""
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.io.fleet import MCLFleetServer
from montecarlolocalisation.models import filter as mcl
from montecarlolocalisation.models import sensor

N_ROBOTS = 3
N_BEAMS = 8
ANGLES = np.deg2rad(np.linspace(-118.0, 118.0, N_BEAMS)).astype(np.float32)


@pytest.fixture(scope="module")
def cfg():
    return FilterConfig(num_particles=256, sensor=SensorModelConfig())


@pytest.fixture(scope="module")
def fleet(default_map, cfg):
    return MCLFleetServer(default_map, cfg, ANGLES, n_robots=N_ROBOTS,
                          seed=7)


def _sim_streams(m, cfg, ticks):
    """Per-robot encoder/scan streams from different true poses."""
    poses = [jnp.array([1.25, 1.25, 0.0]), jnp.array([2.85, 2.05, 1.2]),
             jnp.array([0.45, 3.65, -0.7])]
    ranges = np.stack([
        np.asarray(sensor.simulate_scan(m, p, jnp.asarray(ANGLES),
                                        cfg.sensor).ranges)
        for p in poses])                              # [R, B]
    enc = np.linspace(0.05, 0.15, N_ROBOTS, dtype=np.float32)
    return enc, np.repeat(ranges[None], ticks, 0)     # [T, R, B]


def test_fleet_matches_standalone_filters(default_map, cfg, fleet):
    m = default_map
    ticks = 4
    enc, rng_t = _sim_streams(m, cfg, ticks)
    fleet.reset(seed=7)
    outs = [fleet.tick(enc, enc, rng_t[t]) for t in range(ticks)]
    assert outs[-1]["tick"] == ticks

    # Standalone replica of robot r: same fold_in key, same stream.
    step = jax.jit(lambda st, el, er, rg: mcl.mcl_step(
        st, el, er, sensor.Scan(angles=jnp.asarray(ANGLES), ranges=rg,
                                mask=jnp.ones((N_BEAMS,), bool)),
        m, cfg))
    for r in range(N_ROBOTS):
        key = jax.random.fold_in(jax.random.PRNGKey(7), np.uint32(r))
        st = mcl.init_state(key, m, cfg)
        for t in range(ticks):
            st, out = step(st, jnp.float32(enc[r]), jnp.float32(enc[r]),
                           jnp.asarray(rng_t[t, r]))
        np.testing.assert_allclose(
            np.asarray(fleet.state.particles[r]), np.asarray(st.particles),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            outs[-1]["confidence"][r], float(out.confidence), atol=1e-6)
        assert outs[-1]["cell_pose"][r] == [int(v) for v in out.cell_pose]


def test_reset_robot_only_touches_one(default_map, cfg, fleet):
    m = default_map
    enc, rng_t = _sim_streams(m, cfg, 2)
    fleet.reset(seed=7)
    for t in range(2):
        fleet.tick(enc, enc, rng_t[t])
    before = np.asarray(fleet.state.particles)
    fleet.reset_robot(1, seed=99)
    after = np.asarray(fleet.state.particles)
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[2], before[2])
    assert not np.array_equal(after[1], before[1])
    # The re-initialized robot matches a fresh standalone init (allclose:
    # the server jits init_state and jit fuses the sample arithmetic a few
    # ulps differently from eager).
    fresh = mcl.init_state(
        jax.random.fold_in(jax.random.PRNGKey(99), np.uint32(1)), m, cfg)
    np.testing.assert_allclose(after[1], np.asarray(fresh.particles),
                               rtol=0, atol=1e-6)

    with pytest.raises(ValueError):
        fleet.reset_robot(N_ROBOTS)


def test_fleet_jsonl_protocol_and_checkpoint(default_map, cfg, tmp_path):
    m = default_map
    fl = MCLFleetServer(m, cfg, ANGLES, n_robots=N_ROBOTS, seed=3)
    enc, rng_t = _sim_streams(m, cfg, 1)
    ckpt = str(tmp_path / "fleet.npz")
    lines = [
        json.dumps(dict(encoder_left=enc.tolist(),
                        encoder_right=enc.tolist(),
                        ranges=rng_t[0].tolist())),
        json.dumps(dict(cmd="checkpoint", path=ckpt)),
        json.dumps(dict(cmd="stats")),
        json.dumps(dict(ranges="wrong shape")),     # error, loop survives
        json.dumps(dict(cmd="reset", robot=0, seed=5)),
        json.dumps(dict(cmd="restore", path=ckpt)),
        json.dumps(dict(cmd="shutdown")),
    ]
    out = io.StringIO()
    ticks = fl.serve(iter(lines), out)
    assert ticks == 1
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(replies) == 7
    tick_reply = replies[0]
    assert (len(tick_reply["exact_pose"]) == N_ROBOTS
            and len(tick_reply["exact_pose"][0]) == 3)
    assert len(tick_reply["confidence"]) == N_ROBOTS
    assert replies[1] == dict(ok=True)
    assert replies[2]["n_robots"] == N_ROBOTS
    assert "error" in replies[3]
    assert replies[4] == dict(ok=True)
    assert replies[5] == dict(ok=True)
    assert replies[6] == dict(ok=True)
    # Restore round-trips the post-tick state exactly.
    post = np.load(ckpt)
    np.testing.assert_array_equal(
        np.asarray(fl.state.particles), post["leaf_0"])


def test_fleet_raw_scans(default_map, cfg):
    m = default_map
    fl = MCLFleetServer(m, cfg, ANGLES, n_robots=2, seed=0)
    raw = dict(ranges=[0.5] * 64, angle_min=-2.0, angle_increment=0.0625,
               range_min=0.02, range_max=1.0)
    out = fl.tick_raw([0.1, 0.1], [0.1, 0.1], [raw, raw])
    assert out["tick"] == 1 and len(out["confidence"]) == 2
    with pytest.raises(ValueError):
        fl.tick_raw([0.1, 0.1], [0.1, 0.1], [raw])


@pytest.mark.slow
def test_fleet_pipelined_matches_sync(default_map, cfg):
    """pipeline=True outputs are the sync outputs offset by one tick,
    bit-exact (same jit program, dispatch order unchanged)."""
    m = default_map
    ticks = 3
    enc, rng_t = _sim_streams(m, cfg, ticks)
    sync = MCLFleetServer(m, cfg, ANGLES, n_robots=N_ROBOTS, seed=7)
    pipe = MCLFleetServer(m, cfg, ANGLES, n_robots=N_ROBOTS, seed=7,
                          pipeline=True)
    sync_outs = [sync.tick(enc, enc, rng_t[t]) for t in range(ticks)]
    pipe_outs = [pipe.tick(enc, enc, rng_t[t]) for t in range(ticks)]
    assert pipe_outs[0] is None
    pipe_outs = pipe_outs[1:] + [pipe.flush()]
    assert pipe_outs == sync_outs
    assert pipe.flush() is None

    # serve(): replies come out in dispatch order; the in-flight tick is
    # drained before any command reply and at end of stream.
    pipe.reset(seed=7)
    lines = [json.dumps(dict(encoder_left=enc.tolist(),
                             encoder_right=enc.tolist(),
                             ranges=rng_t[t].tolist()))
             for t in range(ticks)] + [json.dumps(dict(cmd="stats"))]
    out = io.StringIO()
    assert pipe.serve(iter(lines), out) == ticks
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [r["tick"] for r in replies[:ticks]] == list(range(1, ticks + 1))
    assert replies[ticks]["n_robots"] == N_ROBOTS


@pytest.mark.slow
def test_fleet_sharded_over_mesh(default_map, cfg):
    """Robot axis sharded over the 8-device virtual mesh (pure DP)."""
    from jax.sharding import Mesh

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs >= 4 virtual devices")
    mesh = Mesh(np.array(devs[:4]), axis_names=("robot",))
    fl = MCLFleetServer(default_map, cfg, ANGLES, n_robots=8, seed=1,
                        mesh=mesh, robot_axis="robot")
    enc = np.full((8,), 0.1, np.float32)
    rngs = np.full((8, N_BEAMS), 0.7, np.float32)
    out = fl.tick(enc, enc, rngs)
    assert len(out["confidence"]) == 8
    assert np.isfinite(np.asarray(fl.state.particles)).all()
    # Unsharded fleet from the same seed produces the same result.
    fl2 = MCLFleetServer(default_map, cfg, ANGLES, n_robots=8, seed=1)
    out2 = fl2.tick(enc, enc, rngs)
    np.testing.assert_allclose(out["confidence"], out2["confidence"],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Fleet SLAM serving (SLAMFleetServer)
# ---------------------------------------------------------------------------
def _slam_fleet(robots=3, ticks=25, seed=0):
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.io.fleet import SLAMFleetServer
    from montecarlolocalisation.maps import from_map_file
    import os.path as osp

    from montecarlolocalisation.sim import robot

    m = from_map_file(osp.join(osp.dirname(__file__), "..",
                               "montecarlolocalisation", "maps",
                               "default_map.txt"))
    fcfg = FilterConfig()
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    scfg = SLAMConfig(
        num_particles=8,
        mapping=MappingConfig(height=m.height, width=m.width,
                              resolution=float(m.resolution),
                              origin_x=float(m.origin_x),
                              origin_y=float(m.origin_y)),
        sensor=fcfg.sensor, motion=fcfg.motion,
        keyframe_trans=0.15, keyframe_rot=0.5)
    starts = [(1.25, 1.25, 0.0), (2.85, 1.25, 3.14), (1.25, 2.85, 1.57)
              ][:robots]
    eps = []
    for r, sp in enumerate(starts):
        enc, scans, truth = robot.generate_wander_episode(
            jax.random.PRNGKey(seed + 31 * r), m, fcfg, angles, ticks,
            start_pose=sp, slip_noise=0.03, explore=True)
        eps.append((np.asarray(enc), np.asarray(scans)))
    srv = SLAMFleetServer(scfg, angles, starts, seed=seed)
    return srv, eps, m


def test_slam_fleet_matches_standalone_per_robot():
    """Each fleet robot's pose stream must equal a standalone SLAM episode
    run with the fleet's per-robot key (fold_in(seed, r)) — the vmap is a
    batching, not a semantic change."""
    from montecarlolocalisation.models import slam

    srv, eps, m = _slam_fleet()
    T = eps[0][0].shape[0]
    outs = []
    for t in range(T):
        outs.append(srv.tick(
            [e[0][t, 0] for e in eps], [e[0][t, 1] for e in eps],
            np.stack([e[1][t] for e in eps])))
    for r in range(srv.n_robots):
        key = jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(r))
        _, est = slam.run_slam_episode(
            key, eps[r][0], eps[r][1], srv.angles, srv.cfg,
            tuple(srv.start_poses[r]))
        est = np.asarray(est)
        for t in (0, T // 2, T - 1):
            np.testing.assert_allclose(outs[t]["pose"][r],
                                       est[t].astype(np.float64),
                                       atol=1e-4)


def test_slam_fleet_fused_map_covers_more(tmp_path):
    """Three robots mapping from different corners: the FUSED grid has
    more observed evidence than any single robot's best map, and the
    export round-trips through map_server format."""
    from montecarlolocalisation.maps import from_pgm
    from montecarlolocalisation.models import slam as slam_mod

    srv, eps, m = _slam_fleet(ticks=40)
    T = eps[0][0].shape[0]
    for t in range(T):
        srv.tick([e[0][t, 0] for e in eps], [e[0][t, 1] for e in eps],
                 np.stack([e[1][t] for e in eps]))
    fused = srv.fused_logodds()
    per_robot = np.asarray(jax.vmap(slam_mod.best_map)(srv.state))
    observed = lambda lo: (np.abs(lo) > 0.3).sum()
    assert all(observed(fused) >= observed(per_robot[r])
               for r in range(srv.n_robots))
    assert observed(fused) > max(observed(per_robot[r])
                                 for r in range(srv.n_robots))
    out = srv.export_map(str(tmp_path / "fleetmap"))
    assert out["ok"]
    m2 = from_pgm(out["yaml"])
    assert m2.occ.shape == fused.shape
    # Redeploy robot 1: empty map, anchored back at its start pose.
    srv.reset_robot(1)
    per2 = np.asarray(jax.vmap(slam_mod.best_map)(srv.state))
    assert observed(per2[1]) == 0
    np.testing.assert_allclose(np.asarray(srv.state.poses[1, 0]),
                               srv.start_poses[1], atol=1e-5)
    np.testing.assert_array_equal(per2[0], per_robot[0])
