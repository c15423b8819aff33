"""Tests: episode log I/O, checkpoints, raw-log replay, timed primitives, viz."""
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (
    FilterConfig, MotionModelConfig, SensorModelConfig,
)
from montecarlolocalisation.control import timed
from montecarlolocalisation.io import EpisodeLog, load_pytree, replay, save_pytree
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.models import filter as mcl
from montecarlolocalisation.models.sensor import filter_scan
from montecarlolocalisation.utils import viz

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


def test_episode_log_roundtrip(tmp_path):
    log = EpisodeLog(
        encoders=np.random.rand(10, 2).astype(np.float32),
        scan_ranges=np.random.rand(10, 8).astype(np.float32),
        scan_angles=np.linspace(-1, 1, 8).astype(np.float32),
        true_poses=np.random.rand(10, 3).astype(np.float32),
        meta={"seed": 7})
    p = str(tmp_path / "ep.npz")
    log.save(p)
    back = EpisodeLog.load(p)
    np.testing.assert_array_equal(back.encoders, log.encoders)
    np.testing.assert_array_equal(back.true_poses, log.true_poses)
    assert back.meta == {"seed": 7}
    assert back.num_ticks == 10


def test_checkpoint_roundtrip(tmp_path):
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=64)
    st = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    p = str(tmp_path / "ckpt.npz")
    save_pytree(p, st)
    st2 = load_pytree(p, st)
    np.testing.assert_array_equal(np.asarray(st.particles),
                                  np.asarray(st2.particles))
    assert float(st2.confidence) == float(st.confidence)


def test_replay_preprocess_native_matches_numpy():
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.1, 4.0, (5, 726)).astype(np.float32)
    raw[0, 5] = np.nan
    raw[1, 7] = np.inf
    raw[2, 9] = 99.0
    am, inc = math.radians(-135), math.radians(0.352)
    a_n, r_n, m_n = replay.preprocess_episode(raw, am, inc, 0.1, 5.0)
    # NumPy path comparison.
    cfg = SensorModelConfig()
    for k in range(5):
        a, r, mk = filter_scan(raw[k], am, inc, 0.1, 5.0, cfg,
                               pad_to=a_n.shape[1])
        np.testing.assert_allclose(a_n[k], a, atol=1e-6)
        np.testing.assert_allclose(r_n[k], r, atol=1e-6)
        np.testing.assert_array_equal(m_n[k], mk)


def test_replay_feeds_filter():
    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=64)
    rng = np.random.default_rng(1)
    t = 4
    raw = rng.uniform(0.2, 0.9, (t, 726)).astype(np.float32)
    am, inc = math.radians(-135), math.radians(0.352)
    angles, radii, mask = replay.preprocess_episode(raw, am, inc, 0.02, 5.6)
    enc = np.cumsum(rng.uniform(0, 0.2, (t, 2)), axis=0).astype(np.float32)
    st = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    final, outs = jax.jit(lambda s: mcl.run_episode(
        s, enc, radii, angles, maze, cfg, scan_mask=jnp.asarray(mask)))(st)
    assert np.isfinite(np.asarray(final.particles)).all()


def test_timed_rotate_and_drive_kinematics():
    mcfg = MotionModelConfig()
    # rotate pi/3 at speed 5, dt 0.1 (the wanderer's turn).
    n = timed.rotate_ticks(math.pi / 3, 5.0, 0.1, mcfg)
    omega = 5.0 * (mcfg.wheel_size / 2) / (mcfg.wheel_space / 2)
    assert n == math.ceil((math.pi / 3) / omega / 0.1)
    st = timed.start_drive(0.8, 6.0)
    ticks0 = int(st.ticks_left)
    assert ticks0 == timed.drive_ticks(0.8, 6.0)
    st, (wl, wr), song = timed.timed_tick(st)
    assert float(wl) == 6.0 and float(wr) == 6.0 and int(song) == 0
    assert int(st.ticks_left) == ticks0 - 1


def test_timed_drive_obstacle_abort():
    st = timed.start_drive(0.8, 6.0)
    ranges = jnp.full((16,), 0.15)
    mask = jnp.ones((16,), dtype=bool)
    st, (wl, wr), song = timed.timed_tick(st, ranges, mask)
    assert bool(st.aborted)
    assert float(wl) == 0.0 and int(song) == timed.SONG_ABORT
    assert bool(timed.is_done(st))


def test_timed_reference_count_bug_mode():
    # Preserved bug: 'min range' = beam count/2 -> never aborts for >1 beams.
    st = timed.start_drive(0.8, 6.0)
    ranges = jnp.full((16,), 0.01)
    st, _, song = timed.timed_tick(st, ranges, None, count_bug_compat=True)
    assert not bool(st.aborted) and int(song) == 0


def test_viz_render(tmp_path):
    maze = from_map_file(MAP_PATH)
    occ = np.asarray(maze.occ)
    img = viz.render_filter(
        occ,
        particles=np.array([[2.0, 2.0, 0.0], [1.0, 1.0, 1.0]]),
        weights=np.array([0.0, 1.0]),
        best_pose=np.array([2.0, 2.0, 0.0]),
        true_pose=np.array([1.0, 1.0, 0.0]),
        rays=(2.0, 2.0, np.array([0.0, np.pi / 2]), np.array([0.5, 0.8])))
    assert img.shape == (49 * 8, 49 * 8, 3)
    p = str(tmp_path / "frame.ppm")
    viz.save_ppm(img, p)
    with open(p, "rb") as f:
        assert f.read(2) == b"P6"


@pytest.mark.slow
def test_profiling_stage_times():
    from montecarlolocalisation.utils import profiling

    maze = from_map_file(MAP_PATH)
    cfg = FilterConfig(num_particles=128)
    import jax as _jax
    import numpy as _np
    from montecarlolocalisation.models import sensor as S
    angles = _np.deg2rad(_np.linspace(-118, 118, 8)).astype(_np.float32)
    scan = S.simulate_scan(maze, jnp.array([1.25, 1.25, 0.0]), angles,
                           cfg.sensor)
    st = mcl.init_state(_jax.random.PRNGKey(0), maze, cfg)
    t = profiling.stage_times(maze, cfg, scan, st, iters=2)
    assert set(t) == {"motion", "weights", "resample", "cluster", "full"}
    assert t["full"] > 0
