"""Online JSONL server (io/server.py): the live-node deployment surface.

The server must be a faithful ONLINE re-expression of the batch episode
runner: feeding the same episode tick-by-tick must reproduce
run_episode's outputs exactly (same keys, same step function).
"""
import io as pyio
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from montecarlolocalisation.config import FilterConfig
from montecarlolocalisation.io.server import MCLServer
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import filter as mcl, sensor
from montecarlolocalisation.sim import robot

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def _world(n=256, beams=12, ticks=20, seed=0):
    m = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=n)
    angles = np.deg2rad(np.linspace(-118, 118, beams)).astype(np.float32)
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), m, cfg, angles, ticks)
    return m, cfg, angles, np.asarray(enc), np.asarray(scans)


def test_server_matches_run_episode_exactly():
    m, cfg, angles, enc, scans = _world()
    state = mcl.init_state(jax.random.PRNGKey(7), m, cfg)
    _, outs = mcl.run_episode(state, enc, scans, angles, m, cfg)

    srv = MCLServer(m, cfg, angles, seed=7)
    for t in range(enc.shape[0]):
        out = srv.tick(enc[t, 0], enc[t, 1], scans[t])
        np.testing.assert_allclose(
            out["exact_pose"],
            np.round(np.asarray(outs.exact_pose[t], np.float64), 6))
        assert out["cell_pose"] == [int(v) for v in
                                    np.asarray(outs.cell_pose[t])]
        assert out["song"] == int(outs.song[t])
        assert out["wanderer_cmd"] == int(outs.wanderer_cmd[t])
    # Device state advanced identically.
    assert srv.tick_count == enc.shape[0]


def test_server_raw_scan_path():
    # The canonical LIDAR table: a full 726-beam raw frame filters down to
    # exactly the served beam count (crop +-120 deg, skip 20, NaN->1.05).
    m = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=128)
    table = sensor.default_beam_angles(cfg.sensor)
    srv = MCLServer(m, cfg, table, seed=1)
    ranges = [0.7] * 726
    ranges[100] = float("nan")          # dead beam -> 1.05 replacement
    ranges[200] = 5.0                   # out-of-range finite -> dropped
    raw = dict(ranges=ranges, angle_min=-np.deg2rad(135.0),
               angle_increment=np.deg2rad(0.352), range_min=0.02,
               range_max=1.0)
    out = srv.tick_raw(0.1, 0.1, raw)
    assert out["tick"] == 1 and np.isfinite(out["confidence"])


def test_server_checkpoint_restore_roundtrip(tmp_path):
    m, cfg, angles, enc, scans = _world()
    srv = MCLServer(m, cfg, angles, seed=3)
    for t in range(5):
        srv.tick(enc[t, 0], enc[t, 1], scans[t])
    ckpt = str(tmp_path / "state.npz")
    srv.checkpoint(ckpt)
    cont = [srv.tick(enc[t, 0], enc[t, 1], scans[t]) for t in range(5, 10)]
    srv.restore(ckpt)
    replay = [srv.tick(enc[t, 0], enc[t, 1], scans[t])
              for t in range(5, 10)]
    for a, b in zip(cont, replay):
        assert a["exact_pose"] == b["exact_pose"]
        assert a["confidence"] == b["confidence"]


def test_serve_protocol_loop(tmp_path):
    m, cfg, angles, enc, scans = _world(ticks=6)
    srv = MCLServer(m, cfg, angles, seed=0)
    ckpt = str(tmp_path / "ck.npz")
    lines = [
        json.dumps(dict(encoder_left=float(enc[0, 0]),
                        encoder_right=float(enc[0, 1]),
                        ranges=[float(v) for v in scans[0]])),
        json.dumps(dict(cmd="stats")),
        json.dumps(dict(cmd="checkpoint", path=ckpt)),
        "not json at all",
        json.dumps(dict(cmd="unknown_thing")),
        json.dumps(dict(encoder_left=0.2, encoder_right=0.2,
                        ranges=[0.5])),       # wrong lane count -> error
        json.dumps(dict(cmd="restore", path=ckpt)),
        json.dumps(dict(cmd="shutdown")),
        json.dumps(dict(cmd="stats")),        # after shutdown: not reached
    ]
    out = pyio.StringIO()
    ticks = srv.serve(lines, out)
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    assert ticks == 1
    assert replies[0]["tick"] == 1                      # sensor tick
    assert replies[1]["tick"] == 1                      # stats
    assert replies[2] == dict(ok=True)                  # checkpoint
    assert "error" in replies[3]                        # bad json
    assert "error" in replies[4]                        # unknown cmd
    assert "error" in replies[5]                        # lane mismatch
    assert replies[6] == dict(ok=True)                  # restore
    assert replies[7] == dict(ok=True)                  # shutdown
    assert len(replies) == 8                            # loop exited


# ---------------------------------------------------------------------------
# Live SLAM serving (SLAMServer — no reference counterpart: the
# reference's live node REQUIRES the hand-written map at startup)
# ---------------------------------------------------------------------------
def _slam_server(ticks=30, seed=0, slip=0.05):
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.io.server import SLAMServer

    m = from_map_file(MAP_PATH)
    fcfg = FilterConfig()
    angles = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
    scfg = SLAMConfig(
        num_particles=16,
        mapping=MappingConfig(height=m.height, width=m.width,
                              resolution=float(m.resolution),
                              origin_x=float(m.origin_x),
                              origin_y=float(m.origin_y)),
        sensor=fcfg.sensor, motion=fcfg.motion,
        keyframe_trans=0.15, keyframe_rot=0.5)
    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), m, fcfg, angles, ticks,
        start_pose=(1.25, 1.25, 0.0), slip_noise=slip, explore=True)
    srv = SLAMServer(scfg, angles, seed=seed)
    return srv, np.asarray(enc), np.asarray(scans), np.asarray(truth)


def test_slam_server_matches_offline_episode():
    """Feeding the episode tick-by-tick must reproduce the offline
    run_slam_episode pose estimates exactly (same step, same RNG)."""
    from montecarlolocalisation.models import slam

    srv, enc, scans, truth = _slam_server()
    _, est = slam.run_slam_episode(
        jax.random.PRNGKey(0), enc, scans, srv.angles, srv.cfg,
        (1.25, 1.25, 0.0))
    est = np.asarray(est)
    for t in range(enc.shape[0]):
        out = srv.tick(enc[t, 0], enc[t, 1], scans[t])
        np.testing.assert_allclose(out["pose"],
                                   np.round(est[t].astype(np.float64), 6),
                                   atol=1e-5)
        assert set(out) == {"tick", "pose", "best_pose", "ess", "mapped"}
    err = np.hypot(out["pose"][0] - truth[-1, 0],
                   out["pose"][1] - truth[-1, 1])
    assert err < 0.5      # tracking from a known start over 30 ticks


def test_slam_server_export_and_checkpoint(tmp_path):
    from montecarlolocalisation.maps import from_pgm

    srv, enc, scans, _ = _slam_server(ticks=40)
    for t in range(enc.shape[0]):
        srv.tick(enc[t, 0], enc[t, 1], scans[t])
    out = srv.export_map(str(tmp_path / "live"))
    assert out["ok"] and out["yaml"].endswith("live.yaml")
    m2 = from_pgm(out["yaml"])
    assert m2.occ.shape == (srv.cfg.mapping.height, srv.cfg.mapping.width)
    # Wall tensor rows match the maze lattice.
    assert len(out["walls"]) == 6 and len(out["walls"][0]) == 6
    # Checkpoint/restore round-trip: state identical, stream resumes.
    ck = str(tmp_path / "slam.ckpt.npz")
    srv.checkpoint(ck)
    before = np.asarray(srv.state.poses)
    srv.reset(99)
    assert not np.allclose(np.asarray(srv.state.poses), before)
    srv.restore(ck)
    np.testing.assert_array_equal(np.asarray(srv.state.poses), before)


def test_slam_server_jsonl_loop():
    srv, enc, scans, _ = _slam_server(ticks=6)
    lines = []
    for t in range(4):
        lines.append(json.dumps(dict(
            encoder_left=float(enc[t, 0]), encoder_right=float(enc[t, 1]),
            ranges=[float(r) for r in scans[t]])))
    lines.append("not json")
    lines.append(json.dumps(dict(cmd="stats")))
    lines.append(json.dumps(dict(cmd="shutdown")))
    lines.append(json.dumps(dict(cmd="never-reached")))
    out = pyio.StringIO()
    srv.serve(lines, out_stream=out)
    replies = [json.loads(l) for l in out.getvalue().splitlines()]
    assert [r.get("tick") for r in replies[:4]] == [1, 2, 3, 4]
    assert "error" in replies[4]
    assert replies[5] == dict(tick=4, particles=16)
    assert replies[6] == dict(ok=True)
    assert len(replies) == 7    # shutdown exits before the last line


def test_slam_server_replica_mode():
    """replicas=K: outputs report the max-evidence replica (and its
    index); export_map uses the winning replica's map; single-replica
    protocol keys unchanged."""
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.io.server import SLAMServer

    m = from_map_file(MAP_PATH)
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
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(2), m, fcfg, angles, 20,
        start_pose=(1.25, 1.25, 0.0), slip_noise=0.05, explore=True)
    enc, scans = np.asarray(enc), np.asarray(scans)
    srv = SLAMServer(scfg, angles, seed=1, replicas=3)
    for t in range(enc.shape[0]):
        out = srv.tick(enc[t, 0], enc[t, 1], scans[t])
    assert set(out) >= {"tick", "pose", "best_pose", "ess", "mapped",
                        "replica", "log_evidence"}
    ev = out["log_evidence"]
    assert len(ev) == 3 and out["replica"] == int(np.argmax(ev))
    # The reported pose equals a standalone replica run with the same
    # folded key.
    from montecarlolocalisation.models import slam

    key = jax.random.fold_in(jax.random.PRNGKey(1),
                             np.uint32(out["replica"]))
    _, est = slam.run_slam_episode(key, enc, scans, jnp.asarray(angles),
                                   scfg, (1.25, 1.25, 0.0))
    np.testing.assert_allclose(out["pose"],
                               np.asarray(est)[-1].astype(np.float64),
                               atol=1e-5)
