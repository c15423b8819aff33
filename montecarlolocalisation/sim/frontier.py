"""Frontier-driven autonomous exploration under SLAM (closed loop).

Drive toward the NEAREST cell that still has unobserved edges, planned
by BFS over the robot's OWN current map with OPTIMISTIC unknown=open
semantics, localized by the SLAM posterior itself.  No reference
counterpart — the reference's exploration is the blind wanderer and its
map is hand-written (publish_map.py).

Measured honestly (BENCH_DETAILS.md exploration sweeps, rounds 3-5, 12-16
episodes per world family on chip): the freer-side wanderer covers
1.3-1.6x MORE edges per tick than frontier targeting on every family
tried, and the wander-then-frontier "hybrid" composition ALSO loses to
pure wandering (frontier legs travel slower than they earn coverage) —
so the slam preset's default explorer is the wanderer.  Frontier
exploration buys map QUALITY per explored edge and deterministic
targeting (map a NAMED region), not raw coverage.  Two round-5 styles
with measured niches (round-5 exploration table in BENCH_DETAILS):

* `novelty_bias=1` (nwander): avoidance turns steer toward unknown mass
  on the robot's own consensus map — the perfect-MAZE winner (+38%
  coverage, +0.09 F1 over freer-side; neutral-to-negative in open
  rooms).
* `wander_style="wallfollow"`: left-hand wall following — the ROOMS
  coverage winner (0.69 vs 0.60, min 0.54 vs 0.22) and the maze F1
  winner (0.94), but in rooms it pays 3-4x the SLAM pose error:
  wall-parallel motion has no along-track likelihood constraint between
  corners (corridor-sliding ambiguity), which no keyframe or steering
  retune recovered.

The 0.85-coverage-at-1200-ticks target is TRAVEL-BOUND infeasible for
families above 6x6 at reference wander speed (tools/coverage_bound.py:
the spanning-walk lower bound alone exceeds the tick budget).

Two layers:

* `explore_phase` — one jit-compiled `lax.scan` over ticks: simulate
  the LIDAR from the TRUE pose, run `slam.slam_step` (joint pose+map),
  P-drive toward the current waypoint using the SLAM pose estimate
  (`control.controllers.global_p_drive` — the same goToTargetGlobal
  controller the mission executor uses), with the wanderer's
  halves-compare avoidance taking over whenever the forward sector
  blocks; commanded wheel arcs integrate the true dynamics WITH slip
  while the encoders record the commanded arcs (lying odometry — the
  SLAM input).  Waypoint slots are padded to a static count so every
  phase reuses one compilation.
* `run_frontier_slam` — the host loop: after each phase, snap the best
  particle's map to the lattice (`mapping.fit_walls`), list frontier
  cells (any unobserved edge), BFS from the SLAM-estimated cell over
  the optimistic wall graph to the nearest one, and hand the next
  waypoint list to the next phase.  Ends when no frontier remains
  (full coverage) or the phase budget runs out.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FilterConfig, SLAMConfig
from ..control import controllers as C
from ..maps.grid import MazeMap
from ..models import mapping, sensor, slam
from . import robot as R


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ExploreState:
    robot: R.RobotState      # ground truth (+ cumulative encoders)
    slam: slam.SLAMState     # joint (pose, map) posterior
    est: jax.Array           # [3] SLAM pose estimate driving the control
    wp_idx: jax.Array        # int32 into the padded waypoint slots
    turn_left: jax.Array     # int32 avoidance-turn ticks remaining
    turn_sign: jax.Array     # f32 +-1


def init_explore(key, start_pose, scfg: SLAMConfig) -> ExploreState:
    sp = jnp.asarray(start_pose, jnp.float32)
    return ExploreState(
        robot=R.make_robot(*start_pose),
        slam=slam.init_slam(key, start_pose, scfg),
        est=sp, wp_idx=jnp.int32(0),
        turn_left=jnp.int32(0), turn_sign=jnp.float32(1.0))


def _explore_tick(state: ExploreState, tick_key, waypoints, n_wp,
                  m_true: MazeMap, scfg: SLAMConfig, angles,
                  slip_noise: float, scan_noise: float,
                  base_speed: float, turn_speed: float,
                  avoid_thresh: float, arrival_tol: float, dt: float,
                  novelty_bias: float = 0.0,
                  wander_style: str = "freer"):
    # 1. Sense the TRUE world.
    scan = sensor.simulate_scan(m_true, state.robot.pose, angles,
                                scfg.sensor, key=tick_key,
                                noise_sigma=scan_noise)

    # 2. SLAM tick (lying encoders in, joint posterior out).
    new_slam, info = slam.slam_step(
        state.slam, state.robot.encoder_left, state.robot.encoder_right,
        scan.ranges, angles, jnp.ones_like(scan.ranges), scfg)
    est = info["pose"]

    # 3. Behave: waypoint P-drive on the SLAM estimate; wanderer-style
    # halves-compare avoidance when the forward sector blocks (the
    # optimistic planner routes through unknown edges that may turn out
    # to be real walls — bumping into one OBSERVES it, and the next
    # replan routes around).
    slots = waypoints.shape[0]
    wp = waypoints[jnp.clip(state.wp_idx, 0, slots - 1)]
    arrived = ((jnp.abs(est[0] - wp[0]) <= arrival_tol)
               & (jnp.abs(est[1] - wp[1]) <= arrival_tol))
    wp_idx = jnp.where(arrived & (state.wp_idx < n_wp),
                       state.wp_idx + 1, state.wp_idx)
    wp_active = wp_idx < n_wp
    wp_next = waypoints[jnp.clip(wp_idx, 0, slots - 1)]

    r = jnp.where(scan.mask, scan.ranges, 9.99)
    blocked = jnp.min(r) <= avoid_thresh
    half = r.shape[-1] // 2
    sum1 = jnp.sum(jnp.where(scan.mask, scan.ranges, 0.0)[:half])
    sum2 = jnp.sum(jnp.where(scan.mask, scan.ranges, 0.0)[half:])
    if novelty_bias > 0.0:
        # Novelty-biased turn choice: weigh each half-scan by how much
        # UNKNOWN territory (per the robot's OWN consensus map) its beam
        # endpoints touch — the wanderer keeps its speed but its
        # avoidance turns steer toward unmapped space instead of merely
        # freer space (the freer side is often an already-swept loop).
        cons = slam.consensus_map(new_slam)[None]             # [1, H, W]
        observed = (jnp.abs(cons)
                    > 0.25 * scfg.mapping.l_free).astype(jnp.float32)
        theta = est[2]
        sign = -1.0 if scfg.sensor.negate_beam_angle else 1.0
        ray = theta + sign * angles
        ox = est[0] + scfg.sensor.laser_offset * jnp.cos(theta)
        oy = est[1] + scfg.sensor.laser_offset * jnp.sin(theta)
        ex = (ox + scan.ranges * jnp.cos(ray))[None]          # [1, B]
        ey = (oy + scan.ranges * jnp.sin(ray))[None]
        unk = 1.0 - slam._bilinear(observed, ex, ey,
                                   scfg.mapping)[0]           # [B]
        nov = novelty_bias * scfg.sensor.max_range
        sum1 = sum1 + nov * jnp.sum(unk[:half])
        sum2 = sum2 + nov * jnp.sum(unk[half:])
    start_turn = blocked & (state.turn_left == 0)
    # pi/3 timed turn at turn_speed (wanderer_try_final.cpp:167-191).
    omega = turn_speed * (scfg.motion.wheel_size / 2.0) / (
        scfg.motion.wheel_space / 2.0)
    turn_ticks = jnp.int32(jnp.ceil((jnp.pi / 3.0) / (omega * dt)))
    if wander_style == "wallfollow":
        # Keep the followed wall on the LEFT (+theta side): every
        # avoidance turn rotates AWAY from it (heading decreases).
        new_sign = jnp.float32(-1.0)
    else:
        new_sign = jnp.where(sum1 >= sum2, 1.0, -1.0)
    turn_sign = jnp.where(start_turn, new_sign, state.turn_sign)
    turn_left = jnp.where(start_turn, turn_ticks, state.turn_left)
    turning = turn_left > 0

    gl, gr, _ = C.global_p_drive(est, wp_next, base_speed)
    # Waypoints exhausted: SPIN in place — the laser covers ±118°, so a
    # frontier cell reached facing away from its unobserved edge would
    # never observe it (coverage was measured to saturate ~0.5 without
    # this); a full turn observes every edge of the reached cell.  A
    # phase with NO waypoints at all (n_wp == 0: no reachable frontier)
    # wanders forward instead.
    spin = ~wp_active & (n_wp > 0)
    if wander_style == "wallfollow":
        # Left-hand wall following: in a perfect maze the cell graph is
        # a TREE, and hugging one wall traverses EVERY corridor in the
        # optimal 2x(edges) walk — random freer-side wandering needs the
        # cover time of a random walk instead (measured 0.17 coverage at
        # 1200 ticks on 10x10 mazes vs the 0.43 travel bound).  Reactive
        # like the reference wanderer: a differential P-term holds the
        # left-side clearance at a setpoint; blocked front falls through
        # to the timed avoidance turn above (which turns AWAY from the
        # followed side via the freer-side rule, i.e. right).
        off = (-1.0 if scfg.sensor.negate_beam_angle else 1.0) * angles
        left_sector = (off > 0.35) & (off < 1.6) & scan.mask
        left_min = jnp.min(jnp.where(left_sector, scan.ranges, 9.99))
        # Sim heading convention: dtheta = (d_L - d_R) / wheel_space
        # (heading INCREASES with the faster LEFT wheel — reference
        # diffDriveModel, monte_carlo.cpp:695-739), and the followed
        # left sector sits on the +theta side: steering toward a too-far
        # wall (err > 0) needs the LEFT wheel faster.  Gentle gain + a
        # deadband: an aggressive P-term wiggles the heading EVERY tick
        # and each wiggle pays alpha_1|rot| proposal noise — measured to
        # triple the SLAM pose error vs the mostly-straight wanderer.
        err = left_min - 0.45
        err = jnp.where(jnp.abs(err) < 0.06, 0.0, err)
        err = jnp.clip(err, -0.2, 0.2)
        wf_l = base_speed * (1.0 + 1.2 * err)
        wf_r = base_speed * (1.0 - 1.2 * err)
        fwd_l = jnp.where(spin, turn_speed, wf_l)
        fwd_r = jnp.where(spin, -turn_speed, wf_r)
    else:
        fwd_l = jnp.where(spin, turn_speed, base_speed)
        fwd_r = jnp.where(spin, -turn_speed, base_speed)
    left = jnp.where(turning, turn_speed * turn_sign,
                     jnp.where(wp_active, gl, fwd_l))
    right = jnp.where(turning, -turn_speed * turn_sign,
                      jnp.where(wp_active, gr, fwd_r))
    left, right = C.clamp_wheels(left, right)
    turn_left = jnp.maximum(turn_left - 1, 0)

    # 4. Act: truth integrates SLIPPED arcs, encoders record COMMANDED
    # (sim/robot.generate_wander_episode's fault model).
    dl, dr = R.wheel_arcs_from_speeds(left, right, dt, scfg.motion)
    if slip_noise:
        eps = slip_noise * jax.random.normal(
            jax.random.fold_in(tick_key, 1), (2,))
        enc_l, enc_r = state.robot.encoder_left, state.robot.encoder_right
        rb = R.step_dynamics(state.robot, dl * (1.0 + eps[0]),
                             dr * (1.0 + eps[1]), scfg.motion)
        tick_m = scfg.motion.wheel_size * 0.5
        rb = dataclasses.replace(
            rb, encoder_left=enc_l + dl / tick_m,
            encoder_right=enc_r + dr / tick_m)
    else:
        rb = R.step_dynamics(state.robot, dl, dr, scfg.motion)

    new_state = ExploreState(robot=rb, slam=new_slam, est=est,
                             wp_idx=wp_idx, turn_left=turn_left,
                             turn_sign=turn_sign)
    return new_state, (rb.pose, est)


def explore_phase(state: ExploreState, key, waypoints, n_wp,
                  m_true: MazeMap, scfg: SLAMConfig, angles,
                  num_ticks: int, slip_noise: float = 0.03,
                  scan_noise: float = 0.02, base_speed: float = 8.0,
                  turn_speed: float = 5.0, avoid_thresh: float = 0.25,
                  arrival_tol: float = 0.25, dt: float = 0.1,
                  novelty_bias: float = 0.0,
                  wander_style: str = "freer"):
    # Speeds tuned on chip sweeps: faster driving (base 13 / spin 8)
    # raised coverage per tick but wrecked MAP quality (explored-edge F1
    # 0.8-0.9 -> 0.5-0.6; more motion per scan smears the free-space
    # carve and the filter mis-locks) — 8/5 keeps the map usable.
    """One exploration phase under lax.scan; returns (state, (true_poses
    [T, 3], est_poses [T, 3])).  jit with static num_ticks + slot count;
    padded waypoint slots keep one compilation across phases."""
    keys = jax.random.split(key, num_ticks)

    def body(st, k):
        return _explore_tick(st, k, waypoints, n_wp, m_true, scfg,
                             angles, slip_noise, scan_noise, base_speed,
                             turn_speed, avoid_thresh, arrival_tol, dt,
                             novelty_bias, wander_style)

    return jax.lax.scan(body, state, keys)


def frontier_cells(seen: np.ndarray) -> list:
    """Cells with at least one unobserved edge, as (row, col) tuples."""
    unseen = ~np.asarray(seen, bool)
    rs, cs = np.nonzero(unseen.any(axis=-1))
    return list(zip(rs.tolist(), cs.tolist()))


def plan_to_nearest_frontier(walls: np.ndarray, seen: np.ndarray,
                             cur_cell: Tuple[int, int],
                             rng: Optional[np.random.Generator] = None,
                             k_nearest: int = 3) -> list:
    """BFS path over `walls` from cur_cell to a frontier cell; [] when
    none is reachable.

    Pass the CONSERVATIVE wall graph (unexplored=wall) for the primary
    plan: the robot then routes only through KNOWN-open edges to a cell
    that still has an unobserved edge and OBSERVES the unknown from
    there (the laser out-ranges a cell) — routing never bets on an
    unexplored edge being open, which otherwise has the explorer
    bumping against real walls behind optimistic paths for whole phases.
    The caller falls back to the optimistic graph only when nothing is
    conservatively reachable (e.g. a mis-estimated current cell).

    Picks randomly among the `k_nearest` shortest reachable frontiers
    (when `rng` given) so a target that fails (arrival is judged on the
    SLAM estimate) rotates instead of being re-picked forever."""
    from ..planning import bfs

    targets = [f for f in frontier_cells(seen) if f != tuple(cur_cell)]
    paths = [p for f in targets
             if (p := bfs.bfs_path(walls, cur_cell, f))]
    if not paths:
        return []
    paths.sort(key=len)
    top = paths[:max(1, k_nearest)]
    if rng is None:
        return top[0]
    return top[int(rng.integers(len(top)))]


@functools.lru_cache(maxsize=8)
def _phase_jit(scfg: SLAMConfig, phase_ticks: int, slip_noise: float,
               kw_items: tuple):
    """One jitted phase shared across calls AND worlds.

    The maze rides as a TRACED argument (MazeMap is a pytree; its
    rasters become inputs, so every same-shape world reuses one
    executable — a multi-world exploration sweep compiles once instead
    of once per map).  The cost: a traced map fails `is_concrete_map`, so the
    TRUE-maze scan simulation inside the phase drops to the onehot
    lookup fallback (the SLAM weight/update path is traced-map-native
    either way) — single-world callers should prefer
    `run_frontier_slam(static_map=True)`.  Config knobs are static via
    the cache key; the cache is bounded (compiled executables are big).
    """
    kw = dict(kw_items)

    def fn(st, k, wps, n_wp, m_true, ang):
        return explore_phase(st, k, wps, n_wp, m_true, scfg, ang,
                             phase_ticks, slip_noise=slip_noise, **kw)

    return jax.jit(fn)


def run_frontier_slam(key, m_true: MazeMap, scfg: SLAMConfig, angles,
                      start_pose=(1.25, 1.25, 0.0), phases: int = 12,
                      phase_ticks: int = 120, wp_slots: int = 12,
                      slip_noise: float = 0.03, static_map: bool = False,
                      policy: str = "frontier",
                      hybrid_growth: float = 0.02,
                      **phase_kw):
    """The full frontier-exploration loop.  Returns (final ExploreState,
    dict with per-phase coverage history and the tick logs).

    `policy` picks the per-phase behavior:
      * "frontier" — every phase BFS-targets the nearest frontier cell
        (the original mode; best map quality per explored edge);
      * "hybrid"   — the round-4 sweep data's composition: WANDER phases
        (the measured coverage/tick winner) by default, frontier
        TARGETING only for phases after the wanderer's coverage growth
        decays below `hybrid_growth` per phase — the wanderer sweeps the
        open loops fast, the frontier planner then digs out the pockets
        the freer-side heuristic never enters.  The fake-wall stall
        escape (randomized wander after two growth-free phases) applies
        to both policies.

    `static_map=True` closure-captures the true maze instead of tracing
    it: the per-phase executable is then specific to THIS world (compile
    once per world, not once per shape) but the in-phase scan simulation
    keeps the concrete-map fast paths (bits/analytic/Pallas).  Right for
    single-world callers (the slam preset); leave False for multi-world
    sweeps where one shared executable across worlds is the win."""
    k_init, key = jax.random.split(jax.random.PRNGKey(key)
                                   if isinstance(key, int) else key)
    state = init_explore(k_init, start_pose, scfg)
    cell_m = float(m_true.cell_meters)
    cell_px = int(round(cell_m / float(m_true.resolution)))
    host_rng = np.random.default_rng(int(np.asarray(
        jax.random.key_data(k_init))[-1]))

    angles_arr = jnp.asarray(angles, jnp.float32)
    if static_map:
        kw = dict(phase_kw)
        phase_fn = jax.jit(lambda st, k, wps, n: explore_phase(
            st, k, wps, n, m_true, scfg, angles_arr, phase_ticks,
            slip_noise=float(slip_noise), **kw))
    else:
        jitted = _phase_jit(scfg, phase_ticks, float(slip_noise),
                            tuple(sorted(phase_kw.items())))
        phase_fn = lambda st, k, wps, n: jitted(st, k, wps, n, m_true,
                                                angles_arr)

    truth_log, est_log, coverage = [], [], []
    for _ in range(phases):
        lo = np.asarray(slam.best_map(state.slam))
        walls_cons, seen = mapping.fit_walls(
            lo, cell_px=cell_px, return_explored=True)
        coverage.append(float(np.mean(seen)))
        if not frontier_cells(seen):
            break                     # full coverage: exploration done
        est = np.asarray(state.est)
        cur = (int(np.clip(est[1] // cell_m, 0, seen.shape[0] - 1)),
               int(np.clip(est[0] // cell_m, 0, seen.shape[1] - 1)))
        # Conservative first (route through KNOWN-open edges only);
        # optimistic fallback covers a mis-estimated current cell or a
        # frontier pocket behind unobserved edges; a plain wander phase
        # (no waypoints — forward + avoidance) is the last resort and
        # still gathers scans.  Two phases without coverage growth also
        # force a wander phase: a FAKE wall in the fitted map can block
        # every route to the remaining frontier (measured: 6-phase
        # stalls), and fresh evidence from a randomized walk is what
        # revises it.
        stalled = (len(coverage) >= 3
                   and coverage[-1] <= coverage[-3] + 1e-9)
        if policy == "hybrid":
            # Wander while it still grows coverage; frontier-target once
            # growth decays.  The first phase always wanders (no map yet).
            grew = (coverage[-1] - coverage[-2]
                    if len(coverage) >= 2 else 1.0)
            want_frontier = (grew < hybrid_growth) and not stalled
        elif policy in ("wander", "wallfollow"):
            # Closed-loop wander only ("wallfollow" additionally sets
            # wander_style via phase_kw at call time; pair "wander" with
            # novelty_bias for the novelty-steered wanderer).
            want_frontier = False
        else:
            want_frontier = not stalled
        path = ([] if not want_frontier else
                plan_to_nearest_frontier(walls_cons, seen, cur, host_rng))
        if not path and want_frontier:
            walls_opt = mapping.fit_walls(lo, cell_px=cell_px,
                                          unexplored_is_wall=False)
            path = plan_to_nearest_frontier(walls_opt, seen, cur,
                                            host_rng)
        from .closed_loop import mission_waypoints

        if path:
            # Cap the per-phase path: a long leg would eat the whole
            # phase and skip the frontier SPIN (the part that actually
            # observes the unknown edges); the remainder re-plans next
            # phase from wherever the robot got to.
            wps = mission_waypoints(path, cell_m)[1:][:min(3, wp_slots)]
        else:
            wps = np.zeros((0, 2), np.float32)
        n_wp = jnp.int32(len(wps))
        pad = np.zeros((wp_slots, 2), np.float32)
        pad[:len(wps)] = wps
        key, sub = jax.random.split(key)
        # Fresh waypoint list -> fresh slot cursor (a carried-over index
        # from the previous phase would mark the new path as already
        # exhausted and leave the robot spinning for the whole phase).
        state = dataclasses.replace(state, wp_idx=jnp.int32(0))
        state, (tp, ep) = phase_fn(state, sub, jnp.asarray(pad), n_wp)
        truth_log.append(np.asarray(tp))
        est_log.append(np.asarray(ep))
    lo = np.asarray(slam.best_map(state.slam))
    _, seen = mapping.fit_walls(lo, cell_px=cell_px, return_explored=True)
    coverage.append(float(np.mean(seen)))
    return state, dict(
        coverage=coverage,
        truth=np.concatenate(truth_log) if truth_log else np.zeros((0, 3)),
        est=np.concatenate(est_log) if est_log else np.zeros((0, 3)))
