"""Pipeline presets — the equivalent of the reference launch files.

Each reference .launch file starts a subset of ROS nodes with the /use_PID
parameter (launch/*.launch, SURVEY.md §2.3).  Here a preset names a fully
configured, jit-compiled pipeline over the same components:

  * "localisation"  — wanderer exploration + MCL on simulated sensors
                      (launch/localisation.launch: PID + wanderer +
                      execute_plan + map + monte_carlo_matrix)
  * "planning"      — MCL + BFS planner + waypoint executor closed-loop
                      (launch/planning.launch)
  * "moving"        — controllers only (launch/moving.launch: PID/wanderer)
  * "challenge"     — gold/pickup TSP mission executed closed-loop
  * "sweep"         — vmap'd multi-episode datagen (new capability)
  * "calibrate"     — differentiable parameter calibration from a log
                      (new capability; models/calibrate)
"""
from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Optional, Tuple

import jax
import numpy as np

from .config import (FilterConfig, MappingConfig, RefineConfig,
                     ResampleConfig, SensorModelConfig)
from .maps import from_map_file
from .maps import maze as maze_mod

_PKG = osp.dirname(osp.abspath(__file__))
DEFAULT_MAP = osp.join(_PKG, "maps", "default_map.txt")
DEFAULT_GOLD = osp.join(_PKG, "maps", "default_gold.txt")
DEFAULT_PICKUP = osp.join(_PKG, "maps", "default_pickup.txt")


@dataclasses.dataclass
class World:
    maze: object
    walls: np.ndarray
    cfg: FilterConfig
    angles: np.ndarray


def make_world(map_path: str = DEFAULT_MAP, num_particles: int = 1500,
               num_beams: int = 24, ray_mode: str = "fixed",
               refine_iters: int = 0,
               ess_threshold=None) -> World:
    """World from a map file: reference map.txt wall lists, or a ROS
    map_server YAML (+PGM) — the planner then runs on the synthesized
    cell-lattice wall tensor (maps/pgm.py).

    refine_iters > 0 enables gradient-guided particle refinement
    (models/refine); ess_threshold enables the ESS-gated resampling
    schedule (models/resample.ess_gated_resample).  Both opt-in.
    """
    if map_path.endswith((".yaml", ".yml")):
        from .maps import from_pgm

        maze = from_pgm(map_path)
        walls = np.asarray(maze.walls)
    else:
        maze = from_map_file(map_path)
        walls = maze_mod.walls_to_tensor(maze_mod.load_map_file(map_path))
    cfg = FilterConfig(num_particles=num_particles,
                       sensor=SensorModelConfig(ray_mode=ray_mode),
                       refine=RefineConfig(iters=refine_iters),
                       resample=ResampleConfig(ess_threshold=ess_threshold))
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, num_beams)).astype(np.float32)
    return World(maze=maze, walls=walls, cfg=cfg, angles=angles)


def run_localisation(world: World, seed: int = 0, num_ticks: int = 200,
                     start=(2.05, 2.05, 0.0)):
    """Wander + globally localize; returns (final_state, outputs, truth)."""
    from .models import filter as mcl
    from .sim import robot

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc, scans, truth = robot.generate_wander_episode(
        k1, world.maze, world.cfg, world.angles, num_ticks, start_pose=start)
    state = mcl.init_state(k2, world.maze, world.cfg)
    final, outs = jax.jit(
        lambda s: mcl.run_episode(s, enc, scans, world.angles, world.maze,
                                  world.cfg))(state)
    return final, outs, truth


def run_planning(world: World, start_cell=(2, 2), goal_cell=(4, 4),
                 seed: int = 0, num_ticks: int = 800):
    """BFS plan + closed-loop waypoint following under MCL."""
    from .planning import bfs
    from .sim import closed_loop

    path = bfs.bfs_path(world.walls, start_cell, goal_cell)
    wps = closed_loop.mission_waypoints(path)
    sx, sy = wps[0]
    # The reference executor skips the first plan cell (the robot already
    # stands there, moveToPosition_server.cpp:578); otherwise a cold-start
    # robot must wander BACK to its origin before making progress.
    drive_wps = wps[1:] if len(wps) > 1 else wps
    final, outs = jax.jit(lambda k: closed_loop.run_closed_loop(
        k, world.maze, world.cfg, drive_wps, num_ticks, world.angles,
        start_pose=(float(sx), float(sy), 0.0)))(jax.random.PRNGKey(seed))
    return path, final, outs


def run_challenge(world: World, start_cell=(5, 0),
                  gold_path: str = DEFAULT_GOLD,
                  pickup_path: str = DEFAULT_PICKUP,
                  seed: int = 0, num_ticks: int = 2000):
    """Gold/pickup TSP mission closed-loop (executeChallenge.cpp)."""
    from .planning import mission
    from .sim import closed_loop

    gold = mission.load_waypoints(gold_path)
    pickup = mission.load_waypoints(pickup_path)
    plan = mission.plan_mission(world.walls, start_cell, gold, pickup)
    if not plan.legs or not plan.legs[0].path:
        # Empty waypoint files or unreachable first goal: nothing to drive.
        return plan, None, None
    cells = [plan.legs[0].path[0]]
    for leg in plan.legs:
        cells.extend(leg.path[1:])
    wps = closed_loop.mission_waypoints(cells)
    sx, sy = wps[0]
    drive_wps = wps[1:] if len(wps) > 1 else wps  # skip the start cell
    final, outs = jax.jit(lambda k: closed_loop.run_closed_loop(
        k, world.maze, world.cfg, drive_wps, num_ticks, world.angles,
        start_pose=(float(sx), float(sy), 0.0)))(jax.random.PRNGKey(seed))
    return plan, final, outs


def run_moving(world: World, seed: int = 0, num_ticks: int = 300,
               start=(2.05, 2.05, 0.0)):
    """Controllers-only roam (launch/moving.launch: wanderer, no MCL)."""
    from .sim import robot

    enc, scans, truth = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), world.maze, world.cfg, world.angles,
        num_ticks, start_pose=start)
    import numpy as np
    tp = np.asarray(truth)
    dist = float(np.sum(np.hypot(np.diff(tp[:, 0]), np.diff(tp[:, 1]))))
    return dict(ticks=num_ticks, distance_m=round(dist, 3),
                final_pose=[round(float(v), 3) for v in tp[-1]])


def run_sweep(world: World, batch: int = 64, num_ticks: int = 150,
              seed: int = 0, mesh=None, tick_chunk=None):
    """vmap'd multi-episode localization sweep; returns metrics dict.

    `tick_chunk` splits the tick scan into host-synced segments
    (bit-identical; see parallel.episodes.run_episode_batch).
    """
    from .parallel import episodes

    from .maps import symmetry

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc, scans, truth = episodes.simulate_episode_batch(
        k1, world.maze, world.cfg, world.angles, num_ticks, batch,
        start_pose=(2.05, 2.05, 0.0))
    final, outs = episodes.run_episode_batch(
        k2, world.maze, world.cfg, enc, scans, world.angles, mesh=mesh,
        tick_chunk=tick_chunk)
    sym = symmetry.maze_symmetries(world.maze.walls,
                                   float(world.maze.cell_meters))
    return episodes.sweep_rmse(final, truth, sym=sym)


def run_mapping(world: World, seed: int = 0, num_ticks: int = 600,
                robots: int = 8, relocalize: bool = True,
                pose_source: str = "true", slip_noise: float = 0.0,
                export: Optional[str] = None):
    """Explore -> map -> localize on the LEARNED map (models/mapping).

    `robots` wanderers explore from spread-out starts (their per-episode
    maps fuse by log-odds addition), the fused grid snaps onto the cell
    lattice (fit_walls), and — the closing of the loop the reference
    cannot do (its map.txt is hand-written) — a fresh episode localizes
    against the learned map using scans generated on the TRUE maze.

    pose_source "true" maps from ground-truth poses (SLAM front end
    assumed); "odom" dead-reckons each robot's encoder log from its known
    start (models/mapping.dead_reckon_poses) — pair with `slip_noise` to
    study mapping under realistic odometry drift.
    """
    from .maps import grid
    from .models import filter as mcl
    from .models import mapping
    from .sim import robot

    m = world.maze
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    # Spread starts over the cell lattice (cell centers, row-major stride).
    n_r, n_c = m.n_rows, m.n_cols
    cells = [(r, c) for r in range(n_r) for c in range(n_c)]
    stride = max(1, len(cells) // max(robots, 1))
    starts = [(c * m.cell_meters + m.cell_meters / 2 + 0.05,
               r * m.cell_meters + m.cell_meters / 2 + 0.05,
               0.8 * i)
              for i, (r, c) in enumerate(cells[::stride][:robots])]

    if pose_source not in ("true", "odom"):
        raise ValueError(f"unknown pose_source {pose_source!r}")
    lo = None
    for i, sp in enumerate(starts):
        enc, scans, poses = robot.generate_wander_episode(
            jax.random.fold_in(jax.random.PRNGKey(seed), i), m, world.cfg,
            world.angles, num_ticks, start_pose=sp, slip_noise=slip_noise,
            explore=True)
        if pose_source == "odom":
            poses = mapping.dead_reckon_poses(enc, sp, world.cfg.motion)
        ep = mapping.map_episode(poses, scans, world.angles, mc,
                                 world.cfg.sensor)
        lo = ep if lo is None else lo + ep
    lo = np.asarray(lo)
    learned_walls = mapping.fit_walls(
        lo, cell_px=int(round(m.cell_meters / m.resolution)))
    out = dict(robots=len(starts), ticks_per_robot=num_ticks,
               explored_frac=float(np.mean(np.abs(lo) > 0.5)),
               **mapping.wall_metrics(learned_walls, np.asarray(m.walls)))
    if export:
        # Publish the learned map in ROS map_server format (trinary PGM +
        # YAML); `--map <export>.yaml` then runs the whole stack on it.
        base = export[:-5] if export.endswith(".yaml") else export
        mapping.export_learned_map(lo, mc, base + ".pgm", base + ".yaml")
        out["exported"] = base + ".yaml"

    if relocalize:
        cell_px = int(round(m.cell_meters / m.resolution))
        out.update(_relocalize_on(
            _maze_from_wall_tensor(learned_walls), m, world,
            max(num_ticks, 200), seed + 1000,
            explored_px=np.abs(lo) > 0.5,
            known_maze=_maze_from_wall_tensor(mapping.fit_walls(
                lo, cell_px=cell_px, unexplored_is_wall=False))))
    return out


def _maze_from_wall_tensor(learned_walls) -> "object":
    """Fitted [R, C, 4] wall tensor -> MazeMap (clean lattice raster)."""
    from .maps import grid

    lists = [[[e for e in range(4) if learned_walls[r, c, e]]
              for c in range(learned_walls.shape[1])]
             for r in range(learned_walls.shape[0])]
    return grid.from_walls(lists)


def _relocalize_on(learned_maze, true_maze, world: World, num_ticks: int,
                   seed: int, batch: int = 8,
                   start_pose=(2.05, 2.05, 0.0), explored_px=None,
                   coverage_thresh: float = 0.8, known_maze=None,
                   replicas: int = 8) -> dict:
    """Localize a fresh episode SWEEP against a learned map.

    Scans are generated on the TRUE maze (the world the robot actually
    senses); the filter runs on the LEARNED one.  Sweep fractions, not
    single episodes — the aliased maze is seed-chaotic per episode.

    `explored_px` ([H, W] bool, pixels with map evidence) makes the
    metric coverage-aware: a PARTIAL map cannot support localization
    from territory the mapper never visited (the conservative
    unexplored=wall fit walls it off), so the reloc episodes are also
    scored restricted to those whose TRUE trajectory stayed within
    explored pixels >= `coverage_thresh` of its ticks —
    `reloc_in_coverage_frac` over `reloc_in_coverage_n` episodes.  The
    unrestricted fraction stays reported: the gap between the two IS the
    coverage gap.
    """
    from .parallel import episodes

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc, scans, truth = episodes.simulate_episode_batch(
        k1, true_maze, world.cfg, world.angles, num_ticks, batch=batch,
        start_pose=start_pose)
    if replicas > 1:
        # Evidence-selected filter replicas (run_episode_replicas): the
        # deployment-correct reloc procedure on an aliased partial map —
        # which mode a single filter stream locks is seed-chaotic, the
        # accumulated likelihood discriminates (chip, six 16-episode
        # seed sets on half-explored maps at T=300: 46/96 single stream
        # -> 62/96 at K=4 -> 72/96 at K=8 — the r4 VERDICT 12/16 bar,
        # BENCH_DETAILS r5 reloc table).
        final, _, _ = episodes.run_episode_replicas(
            k2, learned_maze, world.cfg, enc, scans, world.angles,
            replicas=replicas, known_map=known_maze)
    else:
        final, _ = episodes.run_episode_batch(
            k2, learned_maze, world.cfg, enc, scans, world.angles,
            known_map=known_maze)
    best = np.asarray(final.best_pose)
    tpa = np.asarray(truth)                       # [B, T, 3]
    tp = tpa[:, -1, :]
    conf = best[:, 0] >= 0
    err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
    hit = conf & (err < 0.4)
    out = dict(
        reloc_converged_frac=float(np.mean(hit)),
        reloc_median_error_m=round(
            float(np.median(err[hit])) if hit.any() else float("nan"), 4))
    if explored_px is not None:
        ex = np.asarray(explored_px, bool)
        m = true_maze
        rows = np.clip((tpa[..., 1] - float(m.origin_y))
                       / float(m.resolution), 0, ex.shape[0] - 1
                       ).astype(int)
        cols = np.clip((tpa[..., 0] - float(m.origin_x))
                       / float(m.resolution), 0, ex.shape[1] - 1
                       ).astype(int)
        in_cov = ex[rows, cols].mean(axis=1)      # [B] per-episode frac
        covered = in_cov >= coverage_thresh
        out.update(
            reloc_in_coverage_n=int(covered.sum()),
            reloc_in_coverage_frac=round(
                float(np.mean(hit[covered])) if covered.any()
                else float("nan"), 4))
    return out


def _track_on(learned_maze, true_maze, world: World, num_ticks: int,
              seed: int, batch: int = 8,
              start_pose=(1.25, 1.25, 0.0), known_maze=None,
              explored_px=None, coverage_thresh: float = 0.8) -> dict:
    """Pose TRACKING on a learned map from a KNOWN start (the post-SLAM
    deployment mode: the robot knows where it finished mapping).  Fresh
    wander episodes sense the TRUE maze; each filter starts as a tight
    cloud at the start pose (mcl.init_tracking_state) on the LEARNED
    map.  Reports the fraction of episodes still within 0.4 m at the end
    and the median final error — the map-quality signal that global
    relocalization (brittle on any partial map) cannot give.

    `explored_px` adds the coverage-aware pair (mirroring
    `_relocalize_on`): the scripted non-explore eval wanderer is a
    DETERMINISTIC walk of the true maze (episodes differ only in scan
    noise), and on a ~half-explored map that canonical walk EXITS the
    mapped region between ticks ~200 and ~300 — every filter is then
    "lost" OUTSIDE its map at the final tick and the unrestricted
    fraction reads 0.0 even when in-coverage tracking is near-perfect
    (measured: 0.875 at 200 ticks vs 0.0 at 300 on the same map).
    `track_in_coverage_frac`/`_n` score only episodes whose true
    trajectory stayed within explored pixels >= `coverage_thresh` of
    its ticks; the gap between the pairs IS the coverage gap.
    """
    from .models import filter as mcl
    from .parallel import episodes

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    enc, scans, truth = episodes.simulate_episode_batch(
        k1, true_maze, world.cfg, world.angles, num_ticks, batch=batch,
        start_pose=start_pose)
    keys = jax.random.split(k2, batch)
    final, outs = jax.jit(jax.vmap(lambda k, e, s: mcl.run_episode(
        mcl.init_tracking_state(k, learned_maze, world.cfg, start_pose),
        e, s, world.angles, learned_maze, world.cfg,
        known_map=known_maze)))(keys, enc, scans)
    best = np.asarray(final.best_pose)
    tpa = np.asarray(truth)                       # [B, T, 3]
    tp = tpa[:, -1, :]
    err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
    ok = (best[:, 0] >= 0) & (err < 0.4)
    out = dict(
        track_on_learned_frac=float(np.mean(ok)),
        track_median_error_m=round(float(np.median(err)), 4))
    if explored_px is not None:
        ex = np.asarray(explored_px, bool)
        m = true_maze
        rows = np.clip((tpa[..., 1] - float(m.origin_y))
                       / float(m.resolution), 0, ex.shape[0] - 1
                       ).astype(int)
        cols = np.clip((tpa[..., 0] - float(m.origin_x))
                       / float(m.resolution), 0, ex.shape[1] - 1
                       ).astype(int)
        in_cov = ex[rows, cols]                   # [B, T]
        covered = in_cov.mean(axis=1) >= coverage_thresh
        out.update(
            track_in_coverage_n=int(covered.sum()),
            track_in_coverage_frac=round(
                float(np.mean(ok[covered])) if covered.any()
                else float("nan"), 4))
        # "Tracked until it left the map": score each filter at the end
        # of the INITIAL in-coverage prefix — the last tick before the
        # walk first exits explored pixels (final tick if it never
        # does).  A later exit should not erase the tracking the map
        # could support; the last in-coverage tick ANYWHERE is the
        # wrong anchor (the walk may briefly re-enter long after the
        # filter was legitimately lost off-map — measured to score an
        # always-0).
        # MCLOutput.exact_pose[t] is published BEFORE tick t's update
        # (mcl_step publishes first — reference tick order), so the
        # estimate at index t reflects truth at t-1.  Shift to the
        # POST-update estimate per tick: post[t] = exact_pose[t+1], with
        # final.best_pose closing the last slot — now estimate and truth
        # refer to the same tick (and the full-coverage case scores the
        # same pose track_on_learned_frac does).
        bp = np.asarray(outs.exact_pose)          # [B, T, 3] (sentinel
        # (-1,-1,-1) while lost — same semantics as final.best_pose)
        post = np.concatenate(
            [bp[:, 1:], np.asarray(final.best_pose)[:, None, :]], axis=1)
        exits = ~in_cov
        t_edge = np.where(exits.any(axis=1),
                          np.maximum(np.argmax(exits, axis=1) - 1, 0),
                          in_cov.shape[1] - 1)
        has = in_cov[:, 0]                        # started in coverage
        be = post[np.arange(batch), t_edge]
        te = tpa[np.arange(batch), t_edge]
        err_e = np.hypot(be[:, 0] - te[:, 0], be[:, 1] - te[:, 1])
        ok_e = has & (be[:, 0] >= 0) & (err_e < 0.4)
        out["track_to_coverage_edge_frac"] = round(
            float(np.mean(ok_e[has])) if has.any() else float("nan"), 4)
    return out


def run_slam(world: World, seed: int = 0, num_ticks: int = 600,
             num_particles: int = 128, slip_noise: float = 0.03,
             relocalize: bool = True, mission: bool = False,
             mission_ticks: int = 2000,
             gold_path: str = DEFAULT_GOLD,
             pickup_path: str = DEFAULT_PICKUP,
             export: Optional[str] = None,
             explore_mode: str = "wander",
             proposal_candidates: int = 1,
             keyframe: Optional[Tuple[float, float]] = (0.15, 0.5),
             replicas: int = 4):
    """The full SLAM autonomy loop the reference cannot close.

    The reference stack REQUIRES a hand-written map.txt (publish_map.py:
    14-33) before monte_carlo.cpp can localize (its map arrives once at
    startup, monte_carlo.cpp:82-84).  This preset starts from NOTHING but
    encoders + scans:

      1. explore with wheel slip ON (encoders lie) — "wander" (default):
         the freer-side scripted wanderer; "frontier": closed-loop
         frontier-driven exploration steered by the SLAM posterior
         itself (sim/frontier — plans over the robot's OWN map).  The
         wanderer measured MORE coverage per tick on every world family
         tried (default maze, BSP offices, 10x10 perfect mazes —
         BENCH_DETAILS.md exploration sweep), so it stays the default;
         frontier trades coverage for map quality and targeting
         (goal-directed mapping of a named region);
      2. RBPF SLAM (models/slam): joint (pose, map) posterior online;
      3. fit_walls — snap the best particle's log-odds grid onto the
         0.8 m cell lattice;
      4. relocalize/track — fresh episode sweeps localize (global) and
         track (known-pose) on the LEARNED map, scans from the true
         world;
      5. --mission: plan the gold/pickup TSP challenge ON the learned
         map and drive it closed-loop — sensing the true maze, the MCL
         filter tracking against the map the robot built itself.
    """
    from .config import SLAMConfig
    from .models import mapping, slam
    from .sim import robot

    m = world.maze
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    # Keyframe-gated map updates default ON (chip-swept at T=2000/3% slip:
    # beats-DR 9->13/16, F1 0.705->0.813, mean err 0.397->0.256 — the
    # long-horizon smear fix); --keyframe 0:0 restores every-tick updates.
    kf_t, kf_r = keyframe if keyframe is not None else (0.0, 0.0)
    scfg = SLAMConfig(num_particles=num_particles, mapping=mc,
                      sensor=world.cfg.sensor, motion=world.cfg.motion,
                      proposal_candidates=proposal_candidates,
                      keyframe_trans=kf_t, keyframe_rot=kf_r)
    start = (1.25, 1.25, 0.0)
    if explore_mode in ("frontier", "hybrid"):
        from .sim import frontier

        phase_ticks = 120
        fst, finfo = frontier.run_frontier_slam(
            jax.random.PRNGKey(seed), m, scfg, world.angles,
            start_pose=start, phases=max(num_ticks // phase_ticks, 1),
            phase_ticks=phase_ticks, slip_noise=slip_noise,
            policy=explore_mode,
            # Single world: capture the maze concretely so the in-phase
            # scan simulation keeps the concrete-map fast paths (the
            # per-world compile was already this preset's cost).
            static_map=True)
        final = fst.slam
        tn, est = finfo["truth"], finfo["est"]
        dr_err = None
        num_ticks = len(tn)
    elif explore_mode == "wander":
        enc, scans, truth = robot.generate_wander_episode(
            jax.random.PRNGKey(seed), m, world.cfg, world.angles,
            num_ticks, start_pose=start, slip_noise=slip_noise,
            explore=True)
        # K RNG replicas, winner by accumulated log evidence (the SIR
        # marginal likelihood, slam.run_slam_replicas): measured to
        # cut pose error and beats-DR tails at F1-neutral cost
        # (BENCH_DETAILS round-5 replica table); replicas=1 runs the
        # single-stream filter.
        if replicas > 1:
            # Host-synced segments of 250 ticks (bit-identical; ROADMAP S6
            # decides whether the default stays).
            final, est, _ = slam.run_slam_replicas(
                jax.random.PRNGKey(seed + 1), enc, scans, world.angles,
                scfg, start, replicas=replicas, tick_chunk=250)
        else:
            final, est = jax.jit(lambda k, e, s: slam.run_slam_episode(
                k, e, s, world.angles, scfg, start))(
                jax.random.PRNGKey(seed + 1), enc, scans)
        tn, est = np.asarray(truth), np.asarray(est)
        dr = np.asarray(mapping.dead_reckon_poses(enc, start,
                                                  world.cfg.motion))
        tail = max(num_ticks // 4, 1)
        dr_err = float(np.hypot(dr[:, 0] - tn[:, 0],
                                dr[:, 1] - tn[:, 1])[-tail:].mean())
    else:
        raise ValueError(f"unknown explore_mode {explore_mode!r}")

    tail = max(num_ticks // 4, 1)   # final-stretch mean (test_slam metric)
    slam_err = float(np.hypot(est[:, 0] - tn[:, 0],
                              est[:, 1] - tn[:, 1])[-tail:].mean())
    lo = np.asarray(slam.best_map(final))
    cell_px = int(round(m.cell_meters / m.resolution))
    learned_walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                            return_explored=True)
    # Quality (explored edges only) separated from coverage: the
    # planner-conservative unexplored=wall default otherwise reads as
    # false positives on any partial exploration.
    expl = mapping.wall_metrics(learned_walls, np.asarray(m.walls),
                                mask=seen)
    out = dict(particles=num_particles, ticks=num_ticks,
               slip_noise=slip_noise, explore_mode=explore_mode,
               poses_finite=bool(np.isfinite(est).all()),
               slam_final_err_m=round(slam_err, 4),
               explored_edge_frac=round(float(np.mean(seen)), 4),
               **{k + "_explored": v for k, v in expl.items()},
               **mapping.wall_metrics(learned_walls, np.asarray(m.walls)))
    if dr_err is not None:
        out["dead_reckon_final_err_m"] = round(dr_err, 4)
    if export:
        base = export[:-5] if export.endswith(".yaml") else export
        mapping.export_learned_map(lo, mc, base + ".pgm", base + ".yaml")
        out["exported"] = base + ".yaml"

    learned_maze = _maze_from_wall_tensor(learned_walls)
    # Unknown-aware deployment pair: the conservative maze above keeps
    # validity/injection/planning semantics (never place hypotheses or
    # routes in unexplored space), while the known-walls-only fit lets
    # the sensor model credit beams that cross the exploration frontier
    # instead of scoring them against phantom unexplored-is-wall edges
    # (sensor.beam_weights_partial) — partial maps degrade instead of
    # cliffing.
    known_maze = _maze_from_wall_tensor(mapping.fit_walls(
        lo, cell_px=cell_px, unexplored_is_wall=False))
    if relocalize:
        # Fresh episodes start at the SLAM anchor — guaranteed-mapped
        # territory; a partial learned map cannot support relocalization
        # from cells the robot never visited, so the coverage-aware
        # fraction (episodes that STAYED in explored pixels) is the map
        # QUALITY signal and the unrestricted one the COVERAGE signal.
        out.update(_relocalize_on(learned_maze, m, world,
                                  min(max(num_ticks // 2, 150), 300),
                                  seed + 1000, start_pose=start,
                                  explored_px=np.abs(lo) > 0.5,
                                  known_maze=known_maze))
        out.update(_track_on(learned_maze, m, world,
                             min(max(num_ticks // 2, 150), 300),
                             seed + 2000, start_pose=start,
                             known_maze=known_maze,
                             explored_px=np.abs(lo) > 0.5))
    if mission:
        # Challenge mission on the robot-built map: TSP + BFS legs planned
        # over the LEARNED wall graph, driven closed-loop with the filter
        # on the learned map and the LIDAR seeing the TRUE maze.
        from .planning import mission as mission_mod
        from .sim import closed_loop

        gold = mission_mod.load_waypoints(gold_path)
        pickup = mission_mod.load_waypoints(pickup_path)
        walls_t = np.asarray(learned_walls, np.uint8)
        plan = mission_mod.plan_mission(walls_t, (1, 1), gold, pickup)
        if plan.legs and plan.legs[0].path:
            cells = [plan.legs[0].path[0]]
            for leg in plan.legs:
                cells.extend(leg.path[1:])
            wps = closed_loop.mission_waypoints(cells)
            sx, sy = wps[0]
            drive_wps = wps[1:] if len(wps) > 1 else wps
            # known_start: the robot ENDED SLAM knowing its pose; the
            # mission tracks from the plan's first cell instead of
            # re-running brittle global localization on a partial map.
            mfinal, _ = jax.jit(lambda k: closed_loop.run_closed_loop(
                k, learned_maze, world.cfg, drive_wps, mission_ticks,
                world.angles, start_pose=(float(sx), float(sy), 0.0),
                known_start=True, sense_m=m))(jax.random.PRNGKey(seed + 2))
            out.update(mission_waypoints_reached=int(mfinal.wp_idx),
                       mission_waypoints_total=len(drive_wps),
                       mission_legs=[list(leg.goal) for leg in plan.legs])
        else:
            out.update(mission_waypoints_reached=0,
                       mission_waypoints_total=0, mission_legs=[])
    return out


def run_calibrate(world: World, seed: int = 0, num_ticks: int = 200):
    """Differentiable-calibration demo: simulate a wander log with the true
    constants, fit (wheel_size, wheel_space) from 15%-perturbed guesses and
    sigma from a 2x-off guess (models/calibrate), report recovery."""
    from .models import calibrate
    from .sim import robot

    mcfg = world.cfg.motion
    start = (2.05, 2.05, 0.0)
    scan_noise = 0.05  # the log's TRUE range noise, what the fit recovers
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(seed), world.maze, world.cfg, world.angles,
        num_ticks, start_pose=start, scan_noise=scan_noise)
    fit = calibrate.fit_motion_params(
        enc, poses, mcfg,
        init=dict(wheel_size=mcfg.wheel_size * 1.15,
                  wheel_space=mcfg.wheel_space * 0.85),
        steps=500, lr=5e-3, start_poses=start)
    sig = calibrate.fit_sensor_sigma(
        world.maze, poses, ranges, world.angles, world.cfg.sensor,
        init_sigma=3.0 * scan_noise, steps=400, lr=5e-2)
    return dict(
        wheel_size_true=mcfg.wheel_size,
        wheel_size_fit=fit["wheel_size"],
        wheel_space_true=mcfg.wheel_space,
        wheel_space_fit=fit["wheel_space"],
        sigma_true=scan_noise,
        sigma_fit=sig["sigma"],
        motion_loss=fit["loss"],
    )
