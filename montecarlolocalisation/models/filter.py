"""The MCL filter: state pytree, one jit step, and episode runners.

This is the JAX replacement for the reference's 10 Hz ROS timer loop
(monte_carlo.cpp:1025-1098 executeParticleFilter + main :1153-1214): the
entire tick — hysteresis state machine, odometry integration, particle
propagation, beam weights, adaptive-injection resampling, k-means
confidence — is ONE pure function `mcl_step(state, obs) -> (state, output)`,
scanned over a recorded/simulated sensor log with `lax.scan`, vmappable over
episodes, and shardable over the particle axis.

Reference tick order preserved exactly (executeParticleFilter):
  1. hysteresis on the PREVIOUS tick's confidence -> events, new thresholds
  2. publish previous best pose (exact + quantized cell pose)
  3. diffDriveModel + sampleMotionModelOdometry (odometry + noise)
  4. updateParticlePos (propagation)
  5. resampleParticles (weights inside; jitter regime = was_lost AFTER step 1)
  6. k-means confidence with the post-hysteresis thresholds
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import FilterConfig
from ..maps.grid import MazeMap, is_valid_pos, world_to_cell
from ..utils.angles import quantize_orientation
from . import cluster, motion, resample, sensor

# Wanderer command codes emitted per tick.
WANDERER_NOOP = -1
WANDERER_STOP = 0
WANDERER_START = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MCLState:
    """Carried filter state — a pytree, trivially checkpointable."""

    particles: jax.Array            # [N, 3] x, y, theta
    weights: jax.Array              # [N]
    odom: motion.OdometryState
    inj: resample.InjectionState
    confidence: jax.Array           # scalar f32
    was_lost: jax.Array             # scalar bool
    cluster_threshold: jax.Array    # scalar f32 (dynamic, monte_carlo.cpp:78)
    confident_threshold: jax.Array  # scalar f32 (dynamic, :80)
    best_pose: jax.Array            # [3] or (-1,-1,-1) sentinel
    key: jax.Array                  # PRNG key


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MCLOutput:
    """Per-tick outputs — the stand-in for the ROS topics."""

    exact_pose: jax.Array     # [3] (/exact_pose)
    cell_pose: jax.Array      # [3] int32 row, col, orientation (/pose)
    confidence: jax.Array
    song: jax.Array           # int32: 0 none, 1 lost, 2 recovered
    wanderer_cmd: jax.Array   # int32: -1 noop, 0 stop, 1 start
    n_injected: jax.Array
    p_inject: jax.Array
    total_weight: jax.Array   # sum of this tick's beam likelihoods —
    #                           log-summed over an episode it is the
    #                           filter's evidence proxy (replica selection)


def init_state(key, m: MazeMap, cfg: FilterConfig,
               known_map: Optional[MazeMap] = None) -> MCLState:
    """Startup state (monte_carlo.cpp:1198-1209): uniform particles,
    zeroed odometry/injection accumulators, lost-side thresholds.

    With `known_map` (partial-map relocalization) the initial cloud is
    drawn over EXPLORED cells only — same mask as injection in mcl_step:
    cells whose four fitted edges are all walls carry no evidence, so
    seeding them wastes half the cloud on a half-explored map."""
    k_sample, k_state = jax.random.split(key)
    mask = (None if known_map is None
            or cfg.init.partial_map_cells not in ("explored", "init-only")
            else ~jnp.all(m.walls, axis=-1))
    particles = resample.sample_uniform_particles(
        k_sample, m, cfg.num_particles, cfg.init, cell_mask=mask)
    h = cfg.hysteresis
    return MCLState(
        particles=particles,
        weights=jnp.full((cfg.num_particles,), cfg.init.init_weight, jnp.float32),
        odom=motion.OdometryState.zero(),
        inj=resample.InjectionState.zero(),
        confidence=jnp.float32(0.0),
        was_lost=jnp.bool_(False),
        cluster_threshold=jnp.float32(h.init_cluster_threshold),
        confident_threshold=jnp.float32(h.init_confident_threshold),
        best_pose=jnp.full((3,), -1.0, jnp.float32),
        key=k_state,
    )


def init_tracking_state(key, m: MazeMap, cfg: FilterConfig, pose,
                        sigma_xy: float = 0.03,
                        sigma_theta: float = 0.05) -> MCLState:
    """Known-pose (tracking) startup: a tight Gaussian cloud at `pose`,
    confident-side thresholds — the post-SLAM deployment mode (the robot
    finished mapping and KNOWS where it is; global relocalization on a
    partial learned map is needlessly brittle).  The reference has no
    analog (its filter always cold-starts uniform, monte_carlo.cpp:1198)."""
    st = init_state(key, m, cfg)
    k1, k2, k3 = jax.random.split(st.key, 3)
    p = jnp.asarray(pose, jnp.float32)
    n = cfg.num_particles
    parts = jnp.stack([
        p[0] + sigma_xy * jax.random.normal(k1, (n,)),
        p[1] + sigma_xy * jax.random.normal(k2, (n,)),
        p[2] + sigma_theta * jax.random.normal(k3, (n,))], axis=-1)
    h = cfg.hysteresis
    return dataclasses.replace(
        st, particles=parts.astype(jnp.float32),
        confidence=jnp.float32(1.0),
        cluster_threshold=jnp.float32(h.conf_cluster_threshold),
        confident_threshold=jnp.float32(h.conf_confident_threshold),
        best_pose=p)


def _hysteresis(state: MCLState, m: MazeMap, cfg: FilterConfig):
    """Lost/recovered state machine (monte_carlo.cpp:1030-1081).

    Returns (was_lost, cluster_thr, conf_thr, song, wanderer_cmd).
    """
    h = cfg.hysteresis
    conf = state.confidence
    thr = state.confident_threshold
    lost_cond = conf < thr
    conf_cond = conf > thr
    to_lost = lost_cond & ~state.was_lost
    recovered = conf_cond & state.was_lost
    best_valid = is_valid_pos(
        m, state.best_pose[0], state.best_pose[1], cfg.valid_pos_offset)
    conf_to_conf = conf_cond & ~state.was_lost & best_valid

    cluster_thr = jnp.where(
        to_lost, jnp.float32(h.lost_cluster_threshold),
        jnp.where(conf_cond, jnp.float32(h.conf_cluster_threshold),
                  state.cluster_threshold))
    conf_thr = jnp.where(
        to_lost, jnp.float32(h.lost_confident_threshold),
        jnp.where(conf_cond, jnp.float32(h.conf_confident_threshold), thr))
    was_lost = jnp.where(to_lost, True,
                         jnp.where(recovered, False, state.was_lost))
    song = jnp.where(to_lost, h.song_lost,
                     jnp.where(recovered, h.song_recovered, 0)).astype(jnp.int32)
    wanderer = jnp.where(
        to_lost, WANDERER_START,
        jnp.where(recovered | conf_to_conf, WANDERER_STOP, WANDERER_NOOP),
    ).astype(jnp.int32)
    return was_lost, cluster_thr, conf_thr, song, wanderer


def cell_pose_msg(best_pose, cell_meters: float = 0.8):
    """World pose -> (row, col, orientation) int32, with (-1,-1,-1) sentinel
    (monte_carlo.cpp:958-1008 publishPosMsg)."""
    wx, wy, theta = best_pose[0], best_pose[1], best_pose[2]
    row, col = world_to_cell(wx, wy, cell_meters)
    orient = quantize_orientation(theta)
    invalid = (wx < 0) | (wy < 0)
    return jnp.where(
        invalid,
        jnp.full((3,), -1, jnp.int32),
        jnp.stack([row, col, orient]),
    )


def mcl_step(
    state: MCLState,
    encoder_left,
    encoder_right,
    scan: sensor.Scan,
    m: MazeMap,
    cfg: FilterConfig,
    known_map: Optional[MazeMap] = None,
) -> Tuple[MCLState, MCLOutput]:
    """One 10 Hz filter tick (pure; jit/vmap/shard_map-safe).

    `known_map` (optional) switches the weighting stage to the
    unknown-aware partial-map scorer (sensor.beam_weights_partial): `m`
    stays the conservative learned maze (validity, injection, hysteresis
    all unchanged), `known_map` is the same fit_walls output with
    unexplored edges OPEN so beams crossing the exploration frontier are
    credited instead of punished against phantom walls.
    """
    key, k_motion, k_resample, k_cluster = jax.random.split(state.key, 4)

    # 1. Hysteresis on previous confidence.
    was_lost, cluster_thr, conf_thr, song, wanderer = _hysteresis(state, m, cfg)

    # 2. Publish previous best pose.
    exact_pose = state.best_pose
    cell_pose = cell_pose_msg(state.best_pose, m.cell_meters)

    # 3-4. Odometry + propagate.
    with jax.named_scope("motion"):
        odom, particles = motion.motion_update(
            k_motion, state.particles, state.odom, encoder_left,
            encoder_right, cfg.motion)

    # 4b. Optional gradient-guided refinement (models/refine, opt-in —
    #     no reference counterpart; cfg.refine.iters=0 skips entirely).
    if cfg.refine.iters > 0:
        from . import refine as _refine

        particles = _refine.refine_particles(m, particles, scan, cfg)

    # 5. Weights + resample (jitter regime = was_lost after hysteresis,
    #    monte_carlo.cpp:1087).
    with jax.named_scope("weights"):
        if known_map is None:
            weights = sensor.beam_weights(m, particles, scan, cfg.sensor,
                                          cfg.valid_pos_offset)
        else:
            weights = sensor.beam_weights_partial(
                m, known_map, particles, scan, cfg.sensor,
                cfg.valid_pos_offset)
    # Partial-map explored-cell injection: fresh draws go only to cells
    # the learned map has evidence for (a cell whose four fitted edges are
    # ALL walls is unexplored or unreachable — no scan can place the
    # robot there, so uniform-over-all-cells injection wastes the draw).
    cell_mask = (None if known_map is None
                 or cfg.init.partial_map_cells != "explored"
                 else ~jnp.all(m.walls, axis=-1))
    with jax.named_scope("resample"):
        if cfg.resample.ess_threshold is None:
            # Reference schedule: fresh per-tick weights, resample every
            # tick.
            particles, weights, inj, info = resample.resample(
                k_resample, particles, weights, state.inj, was_lost, m, cfg,
                cell_mask=cell_mask)
        else:
            # Production SIR schedule: carried weights, resample only when
            # the effective sample size drops below ess_threshold * N.
            particles, weights, inj, info = resample.ess_gated_resample(
                k_resample, particles, weights, state.weights, state.inj,
                was_lost, m, cfg, cell_mask=cell_mask)

    # 6. Cluster confidence with post-hysteresis threshold.  Under the
    #    ESS-gated schedule the carried weights are non-uniform between
    #    resamples, so confidence/pose must be importance-weighted.
    with jax.named_scope("cluster"):
        confidence, best_pose = cluster.cluster_confidence(
            k_cluster, particles, weights, conf_thr, cfg.cluster,
            weighted=cfg.resample.ess_threshold is not None)

    new_state = MCLState(
        particles=particles, weights=weights, odom=odom, inj=inj,
        confidence=confidence, was_lost=was_lost,
        cluster_threshold=cluster_thr, confident_threshold=conf_thr,
        best_pose=best_pose, key=key,
    )
    out = MCLOutput(
        exact_pose=exact_pose, cell_pose=cell_pose, confidence=confidence,
        song=song, wanderer_cmd=wanderer,
        n_injected=info["n_injected"].astype(jnp.int32),
        p_inject=info["p_inject"],
        total_weight=info["total_weight"],
    )
    return new_state, out


def run_episode(
    state: MCLState,
    encoders,            # [T, 2] encoder_left/right (radians)
    scan_ranges,         # [T, B]
    scan_angles,         # [B] static beam table
    m: MazeMap,
    cfg: FilterConfig,
    scan_mask=None,      # [T, B] optional
    known_map: Optional[MazeMap] = None,
) -> Tuple[MCLState, MCLOutput]:
    """lax.scan the filter over a recorded episode (latest-wins tick log).

    scan_angles may be [B] (static beam table) or [T, B] (per-tick tables
    from raw-log replay, io/replay.preprocess_episode).  `known_map`
    activates partial-map unknown-aware weighting (see mcl_step).
    """
    angles = jnp.asarray(scan_angles, jnp.float32)
    if scan_mask is None:
        scan_mask = jnp.ones(scan_ranges.shape, dtype=bool)
    per_tick_angles = angles.ndim == 2

    def body(st, xs):
        if per_tick_angles:
            enc, ang, ranges, mask = xs
        else:
            enc, ranges, mask = xs
            ang = angles
        sc = sensor.Scan(angles=ang, ranges=ranges, mask=mask)
        return mcl_step(st, enc[0], enc[1], sc, m, cfg, known_map=known_map)

    xs = (jnp.asarray(encoders, jnp.float32),
          jnp.asarray(scan_ranges, jnp.float32), scan_mask)
    if per_tick_angles:
        xs = (xs[0], angles, xs[1], xs[2])
    return jax.lax.scan(body, state, xs)
