"""CLI runner: `python -m montecarlolocalisation <preset>`.

The orchestration surface replacing the reference's roslaunch files:
localisation | planning | challenge | sweep.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np


def _dumps(obj) -> str:
    """json.dumps with non-finite floats mapped to null.

    Preset metrics use NaN as "no qualifying data" (e.g.
    reloc_in_coverage_frac / track_to_coverage_edge_frac when no episode
    qualifies, position_error_m when unlocalized); bare NaN is not strict
    JSON, so the one-line CLI output emits null instead — the paired *_n
    count keeps the n=0 signal.
    """
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(obj))


def main() -> None:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation")
    ap.add_argument("preset", choices=["localisation", "planning",
                                       "challenge", "sweep", "moving",
                                       "calibrate", "mapping", "slam",
                                       "serve"])
    ap.add_argument("--map", dest="map_path", default=None,
                    help="map file: reference map.txt wall list, or a ROS "
                         "map_server YAML (+PGM raster)")
    ap.add_argument("--particles", type=int, default=None,
                    help="particle count (default 1500; slam preset: 128 "
                         "FastSLAM particles, each carrying its own map — "
                         "round-5 chip-swept default, BENCH_DETAILS r5 "
                         "SLAM campaign)")
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    # Splits the sweep's tick scan into host-synced segments of this many
    # ticks (bit-identical — see parallel.episodes.run_episode_batch).
    ap.add_argument("--tick-chunk", type=int, default=None)
    ap.add_argument("--robots", type=int, default=1,
                    help="serve preset: robots per batched fleet tick "
                         "(io/fleet.py; 1 = single-stream io/server.py)")
    ap.add_argument("--pipeline", action="store_true",
                    help="serve preset, fleet mode: double-buffered ticks "
                         "(replies lag one tick; fetch of tick t-1 "
                         "overlaps device compute of tick t)")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="gradient-guided particle refinement rounds per "
                         "tick (models/refine; autodiff scan matching — "
                         "opt-in, no reference counterpart)")
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5): "
                         "resample only when ESS < ess*N (production SIR "
                         "schedule; default = reference every-tick)")
    ap.add_argument("--pose-source", choices=["true", "odom"],
                    default="true",
                    help="mapping preset: map from ground-truth poses or "
                         "dead-reckoned encoder logs "
                         "(models/mapping.dead_reckon_poses)")
    ap.add_argument("--slip", type=float, default=None,
                    help="mapping/slam presets: per-tick multiplicative "
                         "wheel slip std (ground motion drifts from the "
                         "encoder log; mapping default 0, slam default "
                         "0.03 — SLAM exists to survive lying encoders)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="mapping/slam presets: write the learned map as "
                         "ROS map_server PGM+YAML (trinary: occupied/free/"
                         "unknown); PATH.yaml then works with --map")
    ap.add_argument("--explore", default="wander",
                    choices=["wander", "frontier", "hybrid"],
                    help="slam preset explorer: 'wander' (default) is "
                         "the freer-side scripted wanderer (measured "
                         "best coverage/tick on the default maze); "
                         "'frontier' plans toward unexplored edges on "
                         "the robot's OWN growing map (sim/frontier, "
                         "closed loop through the SLAM pose estimate); "
                         "'hybrid' wanders while coverage grows and "
                         "frontier-targets the leftover pockets once "
                         "the wanderer saturates")
    ap.add_argument("--slam-replicas", type=int, default=4,
                    help="slam preset: K RNG replicas per episode, "
                         "winner by accumulated log evidence (cuts "
                         "seed-mislock tails; 1 = single stream)")
    ap.add_argument("--slam-candidates", type=int, default=1,
                    help="slam preset: Monte-Carlo optimal-proposal "
                         "candidates per particle (K motion draws, one "
                         "kept by scan likelihood, weights stay exact; "
                         "1 = plain SIR.  Measured: no win on the "
                         "default maze — exploratory knob)")
    ap.add_argument("--keyframe", default=None, metavar="TRANS:ROT",
                    help="slam preset: keyframe map-update gates in "
                         "meters:radians (default 0.15:0.5, re-swept at "
                         "8% slip in round 5; '0:0' = update every tick)")
    ap.add_argument("--mission", action="store_true",
                    help="slam preset: after mapping, plan the gold/pickup "
                         "TSP challenge ON the learned map and drive it "
                         "closed-loop (sensing the true maze) — the full "
                         "explore→SLAM→plan autonomy loop")
    ap.add_argument("--slam-serve", action="store_true",
                    help="serve preset: run LIVE SLAM instead of "
                         "localization (io/server.SLAMServer — joint "
                         "pose+map posterior per JSONL frame, "
                         "'export_map' command writes the learned map; "
                         "for robots WITHOUT a map)")
    ap.add_argument("--adapt", default=None, metavar="[kld:]NMIN:NMAX",
                    help="serve preset (single robot): elastic particle "
                         "budget — halve the count every 20 confident "
                         "ticks down to NMIN, jump to NMAX on a lost "
                         "transition (io/server.py).  'kld:NMIN:NMAX' "
                         "sizes the budget by Fox's KLD-sampling bound "
                         "instead (models/kld.py, AMCL-style)")
    args = ap.parse_args()
    # --particles means SLAM particles (each carrying its own map) for the
    # slam preset; the relocalization filter inside it keeps the full
    # default cloud.
    slam_particles = args.particles if args.preset == "slam" else None
    if args.particles is None or args.preset == "slam":
        args.particles = 1500
    if args.slip is None:
        args.slip = 0.03 if args.preset == "slam" else 0.0
    for name in ("particles", "beams", "batch"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    if args.ticks is not None and args.ticks < 1:
        ap.error("--ticks must be >= 1")

    from . import presets

    world = presets.make_world(
        **({} if args.map_path is None else dict(map_path=args.map_path)),
        num_particles=args.particles, num_beams=args.beams,
        refine_iters=args.refine_iters, ess_threshold=args.ess)

    if args.preset == "localisation":
        final, outs, truth = presets.run_localisation(
            world, seed=args.seed, num_ticks=args.ticks or 200)
        best = np.asarray(final.best_pose)
        tp = np.asarray(truth)[-1]
        err = float(np.hypot(best[0] - tp[0], best[1] - tp[1])) \
            if best[0] >= 0 else float("nan")
        print(_dumps(dict(
            preset="localisation",
            confidence=float(final.confidence),
            best_pose=[round(float(v), 4) for v in best],
            true_pose=[round(float(v), 4) for v in tp],
            position_error_m=round(err, 4),
            songs=[int(s) for s in np.asarray(outs.song) if s != 0][:8])))
    elif args.preset == "planning":
        path, final, outs = presets.run_planning(
            world, seed=args.seed, num_ticks=args.ticks or 800)
        print(_dumps(dict(
            preset="planning", plan=[list(c) for c in path],
            waypoints_reached=int(final.wp_idx),
            waypoints_total=max(len(path) - 1, 1),  # start cell not driven
            final_confidence=float(final.filt.confidence))))
    elif args.preset == "challenge":
        plan, final, outs = presets.run_challenge(
            world, seed=args.seed, num_ticks=args.ticks or 2000)
        print(_dumps(dict(
            preset="challenge",
            tsp_gold_cost=plan.gold_cost,
            legs=[list(leg.goal) for leg in plan.legs],
            waypoints_reached=(int(final.wp_idx) if final is not None
                               else 0))))
    elif args.preset == "moving":
        out = presets.run_moving(world, seed=args.seed,
                                 num_ticks=args.ticks or 300)
        print(_dumps(dict(preset="moving", **out)))
    elif args.preset == "sweep":
        metrics = presets.run_sweep(world, batch=args.batch,
                                    num_ticks=args.ticks or 150,
                                    seed=args.seed,
                                    tick_chunk=args.tick_chunk)
        print(_dumps({k: round(float(v), 4)
                          for k, v in metrics.items()}))
    elif args.preset == "mapping":
        # Explore -> occupancy-grid mapping -> localize on the LEARNED map
        # (models/mapping; no reference counterpart — its map.txt is
        # hand-written).  --robots wanderers explore, maps fuse by
        # log-odds addition.
        out = presets.run_mapping(world, seed=args.seed,
                                  num_ticks=args.ticks or 600,
                                  robots=args.robots if args.robots > 1
                                  else 8,
                                  pose_source=args.pose_source,
                                  slip_noise=args.slip,
                                  export=args.export)
        print(_dumps(dict(preset="mapping", **{
            k: (round(float(v), 4) if isinstance(v, float) else v)
            for k, v in out.items()})))
    elif args.preset == "slam":
        # Full autonomy loop (no reference counterpart — its map.txt is
        # hand-written): explore with lying encoders (wheel slip) -> RBPF
        # SLAM -> fit_walls -> relocalize on the learned map ->
        # --mission: TSP challenge planned ON the learned map.
        kf = None
        if args.keyframe is not None:
            try:
                kf = tuple(float(v) for v in args.keyframe.split(":"))
                assert len(kf) == 2
            except (ValueError, AssertionError):
                ap.error("--keyframe expects TRANS:ROT, e.g. 0.10:0.35")
        out = presets.run_slam(world, seed=args.seed,
                               num_ticks=args.ticks or 1000,
                               num_particles=slam_particles or 128,
                               slip_noise=args.slip,
                               mission=args.mission,
                               explore_mode=args.explore,
                               export=args.export,
                               proposal_candidates=args.slam_candidates,
                               replicas=args.slam_replicas,
                               **({} if kf is None else dict(keyframe=kf)))
        print(_dumps(dict(preset="slam", **{
            k: (round(float(v), 4) if isinstance(v, float) else v)
            for k, v in out.items()})))
    elif args.preset == "calibrate":
        out = presets.run_calibrate(world, seed=args.seed,
                                    num_ticks=args.ticks or 200)
        print(_dumps(dict(preset="calibrate", **{
            k: round(float(v), 5) for k, v in out.items()})))
    elif args.preset == "serve":
        # Online mode: JSONL sensor frames on stdin -> pose stream on
        # stdout (io/server.py; the reference's live-node deployment).
        # --robots R > 1 serves a FLEET: R filters per batched device
        # step (io/fleet.py).
        import sys

        if args.slam_serve:
            from .config import MappingConfig, SLAMConfig

            m = world.maze
            scfg = SLAMConfig(
                num_particles=slam_particles or 128,
                mapping=MappingConfig(
                    height=m.height, width=m.width,
                    resolution=float(m.resolution),
                    origin_x=float(m.origin_x),
                    origin_y=float(m.origin_y)),
                sensor=world.cfg.sensor, motion=world.cfg.motion,
                keyframe_trans=0.15, keyframe_rot=0.5)
            if args.robots > 1:
                # Fleet SLAM: all robots anchor at the default start (a
                # shared world frame); per-robot re-anchoring via the
                # {"cmd": "reset", "robot": i} command.
                from .io.fleet import SLAMFleetServer

                sserver = SLAMFleetServer(
                    scfg, world.angles,
                    [(1.25, 1.25, 0.0)] * args.robots, seed=args.seed)
            else:
                from .io.server import SLAMServer

                sserver = SLAMServer(scfg, world.angles, seed=args.seed,
                                     replicas=args.slam_replicas)
            sserver.serve(sys.stdin)
            print(_dumps(dict(preset="serve", slam=True,
                              robots=args.robots,
                              ticks=sserver.tick_count)),
                  file=sys.stderr)
        elif args.robots > 1:
            from .io.fleet import MCLFleetServer

            fleet = MCLFleetServer(world.maze, world.cfg, world.angles,
                                   n_robots=args.robots, seed=args.seed,
                                   pipeline=args.pipeline)
            ticks = fleet.serve(sys.stdin)
            conf = np.asarray(fleet.state.confidence, np.float64)
            print(_dumps(dict(
                preset="serve", robots=args.robots, ticks=ticks,
                final_confidence=[round(float(c), 4) for c in conf])),
                file=sys.stderr)
        else:
            from .io.server import MCLServer

            adapt, adapt_mode = None, "patience"
            if args.adapt:
                spec = args.adapt
                if spec.startswith("kld:"):
                    adapt_mode, spec = "kld", spec[len("kld:"):]
                lo, _, hi = spec.partition(":")
                adapt = (int(lo), int(hi))
            server = MCLServer(world.maze, world.cfg, world.angles,
                               seed=args.seed, adapt=adapt,
                               adapt_mode=adapt_mode)
            ticks = server.serve(sys.stdin)
            print(_dumps(dict(preset="serve", ticks=ticks,
                                  final_confidence=round(
                                      float(server.state.confidence), 4))),
                  file=sys.stderr)


if __name__ == "__main__":
    main()
