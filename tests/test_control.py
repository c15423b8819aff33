"""Controller tests: PID two-phase drive, APF, wanderer — closed through the
simulated diff-drive dynamics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import (
    APFConfig, MotionModelConfig, PIDConfig, WandererConfig,
)
from montecarlolocalisation.control import controllers as C
from montecarlolocalisation.sim import robot

MCFG = MotionModelConfig()
DT = 0.1


def _closed_loop_pid(target, ticks=400, speed=6.0):
    """Run PID against the simulated robot; returns (poses, done_tick)."""
    rb = robot.make_robot(0.0, 0.0, 0.0)
    st = C.pid_start(target[0], target[1], speed, rb.encoder_left,
                     rb.encoder_right)

    poses = []
    done_at = -1
    for t in range(ticks):
        st, (wl, wr), done = C.pid_tick(st, rb.encoder_left, rb.encoder_right)
        if bool(done) and done_at < 0:
            done_at = t
            break
        dl, dr = robot.wheel_arcs_from_speeds(wl, wr, DT, MCFG)
        rb = robot.step_dynamics(rb, dl, dr, MCFG)
        poses.append((float(rb.x), float(rb.y), float(rb.theta)))
    return np.array(poses), done_at


def test_pid_reaches_point_ahead():
    poses, done_at = _closed_loop_pid((0.8, 0.0))
    assert done_at > 0, "PID never finished"
    x, y, _ = poses[-1]
    assert np.hypot(x - 0.8, y - 0.0) < 0.06


def test_pid_rotates_first_then_drives():
    poses, done_at = _closed_loop_pid((0.0, 0.6))
    assert done_at > 0
    x, y, _ = poses[-1]
    assert np.hypot(x - 0.0, y - 0.6) < 0.06
    # Early ticks: nearly no translation (rotate phase).
    early = poses[: max(3, len(poses) // 10)]
    assert np.hypot(early[-1][0], early[-1][1]) < 0.05


def test_pid_wheel_clamp():
    st = C.pid_start(10.0, 10.0, 6.0, 0.0, 0.0)
    st2, (wl, wr), _ = C.pid_tick(st, 0.0, 0.0)
    assert abs(float(wl)) <= 100.0 and abs(float(wr)) <= 100.0


def test_apf_reaches_goal_no_obstacles():
    cfg = APFConfig.avf()
    rb = robot.make_robot(0.0, 0.0, 0.0)
    st = C.apf_start(0.8, 0.0, 6.0, rb.encoder_left, rb.encoder_right)
    empty = jnp.zeros((8,))
    nomask = jnp.zeros((8,), dtype=bool)
    done = False
    for _ in range(400):
        st, (wl, wr), d = C.apf_tick(st, rb.encoder_left, rb.encoder_right,
                                     empty, empty, nomask, cfg)
        if bool(d):
            done = True
            break
        dl, dr = robot.wheel_arcs_from_speeds(wl, wr, DT, MCFG)
        rb = robot.step_dynamics(rb, dl, dr, MCFG)
    assert done
    assert np.hypot(float(rb.x) - 0.8, float(rb.y)) < 0.15


def test_apf_presets_differ():
    avf = APFConfig.avf()
    pf = APFConfig.potential_field()
    assert avf.repel_sign != pf.repel_sign
    assert avf.mix_sign != pf.mix_sign
    assert pf.attract_gain == 100.0 and pf.heading_gain == 1.0


def test_repulsion_pushes_away():
    cfg = APFConfig.potential_field()
    # Obstacle dead ahead at 0.2 m (within 0.5 m radius): force points away
    # (-x) with repel_sign=-1.
    px = jnp.array([0.2]); py = jnp.array([0.0])
    fx, fy = C.repulsive_force(px, py, jnp.array([True]), 0.5,
                               cfg.repel_gain, cfg)
    assert float(fx) < 0.0
    assert float(fy) == pytest.approx(0.0, abs=1e-9)


def test_wanderer_forward_when_clear():
    st = C.wanderer_init()
    ranges = jnp.full((16,), 2.0)
    mask = jnp.ones((16,), dtype=bool)
    st, (wl, wr) = C.wanderer_tick(st, ranges, mask, jnp.bool_(True))
    assert float(wl) == 8.0 and float(wr) == 8.0


def test_wanderer_turns_when_blocked_and_counts_down():
    cfg = WandererConfig()
    st = C.wanderer_init()
    ranges = jnp.full((16,), 0.1)
    mask = jnp.ones((16,), dtype=bool)
    st, (wl, wr) = C.wanderer_tick(st, ranges, mask, jnp.bool_(True), cfg)
    assert float(wl) == cfg.turn_speed and float(wr) == -cfg.turn_speed
    ticks0 = int(st.turn_ticks_left)
    assert ticks0 > 0
    # Keeps turning even if the path clears mid-rotation (timed rotation).
    clear = jnp.full((16,), 2.0)
    st, (wl, wr) = C.wanderer_tick(st, clear, mask, jnp.bool_(True), cfg)
    assert int(st.turn_ticks_left) == ticks0 - 1
    assert float(wl) == cfg.turn_speed


def test_wanderer_turn_direction_by_halves():
    cfg = WandererConfig()
    # Nearer on second half -> sum1 > sum2 -> turn dir +1 (right).
    ranges = jnp.concatenate([jnp.full((8,), 2.0), jnp.full((8,), 0.1)])
    mask = jnp.ones((16,), dtype=bool)
    st, _ = C.wanderer_tick(C.wanderer_init(), ranges, mask, jnp.bool_(True),
                            cfg)
    assert int(st.turn_dir) == 1
    ranges = jnp.concatenate([jnp.full((8,), 0.1), jnp.full((8,), 2.0)])
    st, _ = C.wanderer_tick(C.wanderer_init(), ranges, mask, jnp.bool_(True),
                            cfg)
    assert int(st.turn_dir) == -1


def test_wanderer_disabled_stops():
    st = C.wanderer_init()
    ranges = jnp.full((16,), 2.0)
    mask = jnp.ones((16,), dtype=bool)
    st, (wl, wr) = C.wanderer_tick(st, ranges, mask, jnp.bool_(False))
    assert float(wl) == 0.0 and float(wr) == 0.0


def test_global_p_drive():
    pose = jnp.array([0.0, 0.0, 0.0])
    wl, wr, stop = C.global_p_drive(pose, jnp.array([1.0, 0.0]), 10.0)
    assert not bool(stop)
    assert float(wl) == pytest.approx(10.0) and float(wr) == pytest.approx(10.0)
    wl, wr, stop = C.global_p_drive(pose, jnp.array([0.05, 0.0]), 10.0)
    assert bool(stop) and float(wl) == 0.0


def test_avf_wanderer_outputs_finite():
    px = jnp.array([0.3, -0.2, 0.0])
    py = jnp.array([0.0, 0.1, 0.35])
    mask = jnp.ones((3,), dtype=bool)
    wl, wr = C.avf_wanderer_tick(px, py, mask)
    assert np.isfinite(float(wl)) and np.isfinite(float(wr))


def test_render_apf_draws_all_marker_layers():
    """viz.render_apf is the stand-in for the reference's APF RViz
    markers (Attract/Repel publishVectorArrow + influence circle,
    avf.cpp:292-294, potential_field.cpp:446-447): scan points, the
    influence circle, and all three force arrows must land in the
    frame."""
    from montecarlolocalisation.utils import viz

    cfg = APFConfig.potential_field()
    # Obstacle points ahead-left WELL inside the influence radius (close
    # enough that the 1/d repulsion is same-scale as attraction — a far
    # obstacle's arrow is sub-pixel after joint normalization).
    ang = np.linspace(-0.4, 0.4, 16)
    d = np.full(16, 0.3 * cfg.influence_radius)
    px, py = d * np.cos(ang + 0.5), d * np.sin(ang + 0.5)
    mask = np.ones(16, bool)
    forces = C.apf_forces(jnp.float32(1.0), jnp.float32(-0.2),
                          jnp.float32(0.0), jnp.float32(0.0),
                          jnp.asarray(px, jnp.float32),
                          jnp.asarray(py, jnp.float32),
                          jnp.asarray(mask), cfg)
    # Repulsion pushes away from the obstacle cluster (negative-y-ish
    # from points at +0.5 rad), attraction toward the target.
    assert float(forces["fx_att"]) > 0 and float(forces["fy_att"]) < 0
    assert float(jnp.hypot(forces["fx_rep"], forces["fy_rep"])) > 0
    img = viz.render_apf(px, py, mask, forces)
    assert img.ndim == 3 and img.shape[2] == 3
    for color in (viz.C_SCAN, viz.C_CIRCLE, viz.C_ATTRACT, viz.C_REPEL,
                  viz.C_TOTAL):
        assert (img == np.array(color, np.uint8)).all(-1).any(), color


def test_apf_forces_matches_apf_tick():
    """The extracted force helper and the control tick must share one
    field: a tick from a reset odometry at the origin must steer by the
    same total force apf_forces reports."""
    cfg = APFConfig.potential_field()
    rb = robot.make_robot(0.0, 0.0, 0.0)
    st = C.apf_start(0.9, 0.4, 6.0, rb.encoder_left, rb.encoder_right)
    px = jnp.asarray([0.3, 0.35], jnp.float32)
    py = jnp.asarray([0.05, -0.05], jnp.float32)
    mask = jnp.ones(2, bool)
    f = C.apf_forces(st.target_x, st.target_y, jnp.float32(0.0),
                     jnp.float32(0.0), px, py, mask, cfg)
    heading = float(jnp.arctan2(f["fy_att"] + f["fy_rep"],
                                f["fx_att"] + f["fx_rep"]))
    _, (wl, wr), _ = C.apf_tick(st, rb.encoder_left, rb.encoder_right,
                                px, py, mask, cfg)
    # heading error > 0 (target up-left of +x heading) -> turn left.
    expect_omega = cfg.heading_gain * heading
    np.testing.assert_allclose(float(wl - wr),
                               2 * cfg.mix_sign * expect_omega, rtol=1e-5)


def test_draw_heading_error_arrow():
    """Heading-error arrow renders at the robot, pointing along
    theta + error (moveToPosition_server.cpp:94-130): the arrow tip
    must land ~0.5 m from the pose in that direction."""
    from montecarlolocalisation.utils import viz

    img = np.full((400, 400, 3), 255, np.uint8)
    pose = np.asarray([4.0, 4.0, 0.5])
    err = 0.7
    out = viz.draw_heading_error(img, pose, err)
    ys, xs = np.nonzero((out == np.array(viz.C_HEADING, np.uint8)).all(-1))
    assert len(xs) > 0
    # Farthest drawn pixel from the robot ~ the 0.5 m tip.
    res, scale = 0.1, 8
    rr, cc = pose[1] / res * scale, pose[0] / res * scale
    dist_px = np.hypot(ys - rr, xs - cc).max()
    np.testing.assert_allclose(dist_px * res / scale, 0.5, atol=0.1)
    tip = np.argmax(np.hypot(ys - rr, xs - cc))
    ang = np.arctan2(ys[tip] - rr, xs[tip] - cc)
    assert abs(ang - (pose[2] + err)) < 0.2
