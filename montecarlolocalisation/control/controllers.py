"""Closed-loop motion controllers as pure per-tick functions.

A re-design of the reference's controller NODES (each a blocking ROS
service loop) into `(ctrl_state, sensors) -> (ctrl_state, wheel_cmd, done)`
ticks that jit-compile inside full episode rollouts:

  * PID two-phase drive      — src/PID_drive.cpp (service PID_drive)
  * APF goal-seeking drive   — src/avf.cpp (Potential_drive) and
                               src/potential_field.cpp (Potential_drive_1),
                               selected via APFConfig presets
  * global-frame APF / P-law — src/moveToPosition_server.cpp:448-554
  * wanderer                 — src/wanderer_try_final.cpp (service Wanderer)
  * APF wanderer             — src/avf_wanderer.cpp (autonomous)

Wheel commands are wheel angular velocities in the reference's diff_drive
units; the simulator integrates them with arc = omega * dt * wheel_size/2
(wanderer_try_final.cpp:63-78 kinematics).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import APFConfig, PIDConfig, WandererConfig, AVFWandererConfig
from ..utils.angles import normalize_angle


def clamp_wheels(left, right, limit: float = 100.0):
    """drive_motor clamp (PID_drive.cpp:66-90)."""
    return jnp.clip(left, -limit, limit), jnp.clip(right, -limit, limit)


# ---------------------------------------------------------------------------
# Odometry integration shared by the controllers (each reference node carries
# its own copy of this dead-reckoning; PID_drive.cpp:97-145).
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalOdom:
    x: jax.Array
    y: jax.Array
    theta: jax.Array
    enc_left: jax.Array
    enc_right: jax.Array

    @staticmethod
    def reset(enc_left, enc_right) -> "LocalOdom":
        z = jnp.float32(0.0)
        return LocalOdom(x=z, y=z, theta=z,
                         enc_left=jnp.asarray(enc_left, jnp.float32),
                         enc_right=jnp.asarray(enc_right, jnp.float32))


def _integrate(o: LocalOdom, enc_l, enc_r, wheel_size=0.062,
               wheel_space=0.265, wrap_theta: bool = False) -> LocalOdom:
    d_left = (enc_l - o.enc_left) * wheel_size * 0.5
    d_right = (enc_r - o.enc_right) * wheel_size * 0.5
    d_center = 0.5 * (d_left + d_right)
    dtheta = (d_left - d_right) / wheel_space
    theta = o.theta + dtheta
    x = o.x + d_center * jnp.cos(o.theta + 0.5 * dtheta)
    y = o.y + d_center * jnp.sin(o.theta + 0.5 * dtheta)
    if wrap_theta:
        theta = normalize_angle(theta)
    return LocalOdom(x=x, y=y, theta=theta,
                     enc_left=jnp.asarray(enc_l, jnp.float32),
                     enc_right=jnp.asarray(enc_r, jnp.float32))


# ---------------------------------------------------------------------------
# PID two-phase drive (src/PID_drive.cpp:197-279 drive_PID)
# ---------------------------------------------------------------------------
PID_ROTATE, PID_DRIVE, PID_DONE = 0, 1, 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PIDState:
    odom: LocalOdom
    phase: jax.Array            # int32: ROTATE -> DRIVE -> DONE
    target_x: jax.Array
    target_y: jax.Array
    base_speed: jax.Array


def pid_start(target_x, target_y, base_speed, enc_left, enc_right) -> PIDState:
    """Service entry: reset the local frame to zero (PID_drive.cpp:199-221)."""
    return PIDState(
        odom=LocalOdom.reset(enc_left, enc_right),
        phase=jnp.int32(PID_ROTATE),
        target_x=jnp.float32(target_x), target_y=jnp.float32(target_y),
        base_speed=jnp.float32(base_speed))


def pid_tick(st: PIDState, enc_left, enc_right,
             cfg: PIDConfig = PIDConfig()):
    """One 10 Hz PID tick -> (state, (wheel_l, wheel_r), done)."""
    odom = _integrate(st.odom, enc_left, enc_right)

    # Phase 1: rotate in place toward atan2(ty, tx) (PID_drive.cpp:147-189).
    rot_target = jnp.arctan2(st.target_y, st.target_x)
    rot_err = normalize_angle(rot_target - odom.theta)
    rot_cmd = cfg.heading_gain * rot_err
    rot_done = jnp.abs(rot_err) < cfg.rotate_exit_rad

    # Phase 2: heading-P toward the point (PID_drive.cpp:97-145).
    theta_m = jnp.arctan2(st.target_y - odom.y, st.target_x - odom.x)
    drv_err = normalize_angle(theta_m - odom.theta)
    drv_cmd = cfg.heading_gain * drv_err
    dist = jnp.hypot(st.target_x - odom.x, st.target_y - odom.y)
    drv_done = dist < cfg.dist_exit_m

    phase = st.phase
    phase = jnp.where((phase == PID_ROTATE) & rot_done, PID_DRIVE, phase)
    phase = jnp.where((phase == PID_DRIVE) & drv_done, PID_DONE, phase)

    in_rot = phase == PID_ROTATE
    in_drv = phase == PID_DRIVE
    left = jnp.where(in_rot, rot_cmd,
                     jnp.where(in_drv, st.base_speed + drv_cmd, 0.0))
    right = jnp.where(in_rot, -rot_cmd,
                      jnp.where(in_drv, st.base_speed - drv_cmd, 0.0))
    left, right = clamp_wheels(left, right, cfg.max_wheel_speed)
    new_st = PIDState(odom=odom, phase=phase, target_x=st.target_x,
                      target_y=st.target_y, base_speed=st.base_speed)
    return new_st, (left, right), phase == PID_DONE


# ---------------------------------------------------------------------------
# APF drives (src/avf.cpp:225-380, src/potential_field.cpp:200-366)
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class APFState:
    odom: LocalOdom
    target_x: jax.Array
    target_y: jax.Array
    base_speed: jax.Array
    done: jax.Array


def apf_start(target_x, target_y, base_speed, enc_left, enc_right) -> APFState:
    return APFState(
        odom=LocalOdom.reset(enc_left, enc_right),
        target_x=jnp.float32(target_x), target_y=jnp.float32(target_y),
        base_speed=jnp.float32(base_speed), done=jnp.bool_(False))


def repulsive_force(points_x, points_y, mask, influence_radius, repel_gain,
                    cfg: APFConfig):
    """Sum of 1/d-style repulsion over scan points in the ROBOT frame
    (avf.cpp:255-276; sign and *0.5 factor are preset-dependent)."""
    d = jnp.hypot(points_x, points_y)
    act = mask & (d < influence_radius) & (d > cfg.min_obstacle_dist)
    safe_d = jnp.maximum(d, cfg.min_obstacle_dist)
    scale = repel_gain * (1.0 / safe_d - 1.0 / influence_radius) / (safe_d**2)
    if cfg.repel_half:
        scale = scale * 0.5
    ux = cfg.repel_sign * points_x / safe_d
    uy = cfg.repel_sign * points_y / safe_d
    act_f = act.astype(jnp.float32)
    return (jnp.sum(act_f * scale * ux, axis=-1),
            jnp.sum(act_f * scale * uy, axis=-1))


def apf_forces(target_x, target_y, x, y, points_x, points_y, mask,
               cfg: APFConfig):
    """The APF field at pose (x, y): gain-scheduled repulsion + attraction.

    Shared by the control tick below and the debug-marker renderer
    (utils/viz.render_apf — the reference publishes exactly these vectors
    as its Attract/Repel RViz arrows plus the active influence circle,
    avf.cpp:292-294, potential_field.cpp:446-447).  Returns a dict with
    fx_att/fy_att (world frame), fx_rep/fy_rep (robot frame sum over scan
    points), the ACTIVE influence radius after near-goal scheduling, and
    the distance-to-goal.
    """
    dist = jnp.hypot(target_x - x, target_y - y)
    # Near-goal gain scheduling (avf.cpp:366-370, potential_field.cpp:272-276).
    near = dist < cfg.near_goal_dist
    repel_gain = jnp.where(near, cfg.near_goal_repel, cfg.repel_gain)
    radius = jnp.where(near, cfg.near_goal_radius, cfg.influence_radius)
    # Fade factor (avf.cpp:250-254).
    if cfg.fade_exponent > 0:
        fade = jnp.clip((dist / cfg.influence_radius) ** cfg.fade_exponent,
                        0.0, 1.0)
        repel_gain = repel_gain * fade
    fx_rep, fy_rep = repulsive_force(points_x, points_y, mask, radius,
                                     repel_gain, cfg)
    fx_att = cfg.attract_gain * (target_x - x)
    fy_att = cfg.attract_gain * (target_y - y)
    return dict(fx_att=fx_att, fy_att=fy_att, fx_rep=fx_rep, fy_rep=fy_rep,
                radius=radius, dist=dist)


def apf_tick(st: APFState, enc_left, enc_right, points_x, points_y, mask,
             cfg: APFConfig):
    """One APF control tick -> (state, (wheel_l, wheel_r), done).

    points_*: scan points in the robot/laser frame ([B]); mask marks valid.
    """
    odom = _integrate(st.odom, enc_left, enc_right,
                      wrap_theta=True)
    f = apf_forces(st.target_x, st.target_y, odom.x, odom.y,
                   points_x, points_y, mask, cfg)
    dist = f["dist"]
    fx_att, fy_att = f["fx_att"], f["fy_att"]
    attract_mag = jnp.hypot(fx_att, fy_att)
    fx, fy = fx_att + f["fx_rep"], fy_att + f["fy_rep"]

    heading = jnp.arctan2(fy, fx)
    err = heading - odom.theta if cfg.subtract_theta else heading
    err = normalize_angle(err)
    omega = cfg.heading_gain * err
    left = st.base_speed + cfg.mix_sign * omega
    right = st.base_speed - cfg.mix_sign * omega

    if cfg.use_attract_exit:
        done = (dist < cfg.dist_exit_m) & (attract_mag < cfg.attract_mag_exit)
    else:
        done = dist < cfg.dist_exit_m
    done = st.done | done
    left = jnp.where(done, 0.0, left)
    right = jnp.where(done, 0.0, right)
    new_st = APFState(odom=odom, target_x=st.target_x, target_y=st.target_y,
                      base_speed=st.base_speed, done=done)
    return new_st, (left, right), done


def global_p_drive(world_pose, target_xy, base_speed, gain: float = 7.0,
                   stop_dist: float = 0.1):
    """goToTargetGlobal (moveToPosition_server.cpp:529-554): heading-P with
    cos-gated linear speed in the WORLD frame, fed by the MCL pose."""
    dx = target_xy[0] - world_pose[0]
    dy = target_xy[1] - world_pose[1]
    distance = jnp.hypot(dx, dy)
    err = normalize_angle(jnp.arctan2(dy, dx) - world_pose[2])
    omega = gain * err
    linear = base_speed * jnp.maximum(0.0, jnp.cos(err))
    stop = distance < stop_dist
    linear = jnp.where(stop, 0.0, linear)
    omega = jnp.where(stop, 0.0, omega)
    return linear + omega, linear - omega, stop


# ---------------------------------------------------------------------------
# Wanderer (src/wanderer_try_final.cpp)
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WandererState:
    turn_ticks_left: jax.Array   # int32 remaining rotation ticks
    turn_dir: jax.Array          # +1 right (dL>0), -1 left


def wanderer_init() -> WandererState:
    return WandererState(turn_ticks_left=jnp.int32(0), turn_dir=jnp.int32(1))


def wanderer_tick(st: WandererState, ranges, mask, enabled,
                  cfg: WandererConfig = WandererConfig(), dt: float = 0.1):
    """One 10 Hz wanderer tick -> (state, (wheel_l, wheel_r)).

    Forward at `forward_speed` while min range > threshold; else rotate
    turn_angle away from the nearer side at turn_speed
    (timerWandererCallback + avoidObstacle, wanderer_try_final.cpp:167-245).
    The reference's blocking timed rotation becomes `turn_ticks_left`
    counted down tick by tick.
    """
    big = jnp.float32(9.99)
    r = jnp.where(mask, ranges, big)
    min_range = jnp.min(r)
    n = ranges.shape[-1]
    half = n // 2
    lane = jnp.arange(n)
    # Pad lanes (mask False) are nonexistent beams and contribute nothing
    # to the side sums (the reference's 9.99 fill-in applies only to real
    # invalid READINGS, wanderer_try_final.cpp:32-48).
    r_sum = jnp.where(mask, ranges, 0.0)
    sum1 = jnp.sum(jnp.where(lane < half, r_sum, 0.0))   # first half
    sum2 = jnp.sum(jnp.where(lane >= half, r_sum, 0.0))  # second half

    # Timed rotation: omega_robot = speed * (wheel_size/2) / (wheel_space/2);
    # ticks = ceil(angle / (omega * dt)) (calculate_rotate_time :63-72).
    omega = cfg.turn_speed * (cfg.wheel_size / 2.0) / (cfg.wheel_space / 2.0)
    total_ticks = jnp.int32(jnp.ceil(cfg.turn_angle / (omega * dt)))

    blocked = min_range <= cfg.threshold
    start_turn = blocked & (st.turn_ticks_left == 0)
    turn_dir = jnp.where(start_turn,
                         jnp.where(sum1 >= sum2, 1, -1).astype(jnp.int32),
                         st.turn_dir)
    ticks = jnp.where(start_turn, total_ticks, st.turn_ticks_left)

    turning = ticks > 0
    fwd = cfg.forward_speed
    left = jnp.where(turning, cfg.turn_speed * turn_dir, fwd)
    right = jnp.where(turning, -cfg.turn_speed * turn_dir, fwd)
    # Disabled -> stop (hasStopped branch, :276-283).
    left = jnp.where(enabled, left, 0.0)
    right = jnp.where(enabled, right, 0.0)
    ticks = jnp.where(enabled, jnp.maximum(ticks - 1, 0), ticks)
    return WandererState(turn_ticks_left=ticks, turn_dir=turn_dir), (left, right)


def avf_wanderer_tick(points_x, points_y, mask,
                      cfg: AVFWandererConfig = AVFWandererConfig()):
    """Pure-repulsion drift (src/avf_wanderer.cpp:173-233): heading from the
    repulsive field alone, P-gain 5, constant base speed."""
    apf = APFConfig(repel_gain=cfg.repel_gain,
                    influence_radius=cfg.influence_radius,
                    repel_half=True, repel_sign=1.0)
    fx, fy = repulsive_force(points_x, points_y, mask,
                             cfg.influence_radius, cfg.repel_gain, apf)
    err = normalize_angle(jnp.arctan2(fy, fx))
    omega = cfg.heading_gain * err
    return cfg.base_speed + omega, cfg.base_speed - omega
