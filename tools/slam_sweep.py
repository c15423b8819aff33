"""SLAM quality sweep: E wander episodes x slip levels, SLAM vs dead
reckoning, map quality at the horizon (models/slam.py).

The measurement behind BENCH_DETAILS.md's RBPF SLAM quality table and the
round-4 knob tuning (Monte-Carlo optimal proposal `--candidates`,
keyframe-gated map updates `--keyframe-trans/--keyframe-rot`):

    python tools/slam_sweep.py --episodes 16 --ticks 1000 --slip 0.03 0.08
    python tools/slam_sweep.py --candidates 8 --keyframe-trans 0.06 \
        --keyframe-rot 0.25 --ticks 2000 --slip 0.03

Per (slip, config): final-quarter mean position error per episode for
SLAM and for dead reckoning (same encoder logs), episodes where SLAM
beats DR, and explored-edge wall F1 of each episode's best map.
"""
import argparse
import os.path as osp
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--slip", type=float, nargs="+", default=[0.03, 0.08])
    ap.add_argument("--candidates", type=int, default=1)
    ap.add_argument("--keyframe-trans", type=float, default=0.0)
    ap.add_argument("--keyframe-rot", type=float, default=0.0)
    ap.add_argument("--alpha-scale", type=float, default=None,
                    help="override SLAMConfig.alpha_scale")
    ap.add_argument("--l-free", type=float, default=None,
                    help="override MappingConfig.l_free (free-space "
                         "carve rate; higher revises smear via "
                         "re-traversal evidence)")
    ap.add_argument("--clamp", type=float, default=None,
                    help="override MappingConfig.clamp (log-odds "
                         "saturation; lower = stale smear revises faster)")
    ap.add_argument("--closure", action="store_true",
                    help="consensus-anchored correlative correction on "
                         "keyframe ticks (models/slam.closure_correction)")
    ap.add_argument("--closure-margin", type=float, default=None)
    ap.add_argument("--closure-xy-range", type=float, default=None)
    ap.add_argument("--closure-theta-range", type=float, default=None)
    ap.add_argument("--offset-tol", type=int, default=None,
                    help="fit_walls offset_tol for the F1 scoring")
    ap.add_argument("--map-est", default="best",
                    choices=["best", "consensus", "rerender"],
                    help="map estimate scored by F1: best particle's grid "
                         "(slam.best_map), the importance-weighted mean "
                         "grid (slam.consensus_map), or a map re-rendered "
                         "from the posterior-mean trajectory "
                         "(mapping.map_episode over the per-tick SLAM "
                         "estimates — mean-pose smoothness kills paint "
                         "jitter and ancestry-switch smear)")
    ap.add_argument("--ess-threshold", type=float, default=None,
                    help="override SLAMConfig.ess_threshold (default 0.7; "
                         "lower = rarer resampling, more trajectory "
                         "diversity preserved)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="K RNG replicas per episode, winner by "
                         "accumulated log evidence "
                         "(slam.run_slam_replicas)")
    ap.add_argument("--per-episode", action="store_true",
                    help="print per-episode (slam_err, dr_err, F1) rows")
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="host-synced SLAM dispatch segments "
                         "(bit-identical)")
    ap.add_argument("--world", default=None, metavar="STYLExRxC:SEED",
                    help="sweep a GENERATED world instead of the default "
                         "maze, e.g. 'rooms6x6:3' or 'maze10x10:7' "
                         "(maps/generator)")
    ap.add_argument("--seed0", type=int, default=0)
    args = ap.parse_args()

    import dataclasses

    from montecarlolocalisation import presets
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.models import mapping, slam
    from montecarlolocalisation.sim import robot

    world = presets.make_world(num_beams=args.beams)
    m = world.maze
    if args.world:
        import re

        from montecarlolocalisation.maps import generator
        from montecarlolocalisation.maps.grid import from_walls

        mm = re.fullmatch(r"(rooms|maze)(\d+)x(\d+):(\d+)", args.world)
        if not mm:
            ap.error("--world expects STYLExRxC:SEED, e.g. rooms6x6:3")
        gen = (generator.generate_rooms if mm.group(1) == "rooms"
               else generator.generate_maze)
        m = from_walls(gen(int(mm.group(2)), int(mm.group(3)),
                           seed=int(mm.group(4))))
    mkw = dict(height=m.height, width=m.width,
               resolution=float(m.resolution),
               origin_x=float(m.origin_x),
               origin_y=float(m.origin_y))
    if args.clamp is not None:
        mkw["clamp"] = args.clamp
    if args.l_free is not None:
        mkw["l_free"] = args.l_free
    mc = MappingConfig(**mkw)
    kw = dict(num_particles=args.particles, mapping=mc,
              sensor=world.cfg.sensor, motion=world.cfg.motion,
              proposal_candidates=args.candidates,
              keyframe_trans=args.keyframe_trans,
              keyframe_rot=args.keyframe_rot)
    if args.alpha_scale is not None:
        kw["alpha_scale"] = args.alpha_scale
    if args.ess_threshold is not None:
        kw["ess_threshold"] = args.ess_threshold
    if args.closure:
        kw["closure"] = True
        for name in ("closure_margin", "closure_xy_range",
                     "closure_theta_range"):
            v = getattr(args, name)
            if v is not None:
                kw[name] = v
    cfg = SLAMConfig(**kw)
    start = (1.25, 1.25, 0.0)
    cell_px = int(round(m.cell_meters / m.resolution))
    tail = max(args.ticks // 4, 1)

    if args.tick_chunk:
        import numpy as _np

        def run(keys, enc_b, sc_b):
            # Host-chunked: vmap each segment over (episode x replica).
            reps = max(args.replicas, 1)
            kk = jnp.stack([jax.vmap(
                lambda k: jax.random.fold_in(k, r))(keys)
                for r in range(reps)])                  # [R, E]
            # state per (R, E)
            states = jax.jit(jax.vmap(jax.vmap(
                lambda k: slam.init_slam(k, start, cfg))))(kk)
            t = enc_b.shape[1]
            est_chunks = []
            for t0 in range(0, t, args.tick_chunk):
                sl = slice(t0, min(t0 + args.tick_chunk, t))
                states, est = jax.jit(jax.vmap(jax.vmap(
                    lambda k, st, e, s: slam.run_slam_episode(
                        k, e, s, world.angles, cfg, start, state0=st),
                    in_axes=(0, 0, 0, 0)), in_axes=(0, 0, None, None)))(
                    kk, states, enc_b[:, sl], sc_b[:, sl])
                jax.block_until_ready(states.poses)
                est_chunks.append(est)
            est = jnp.concatenate(est_chunks, axis=2)   # [R, E, T, 3]
            if reps == 1:
                return jax.tree_util.tree_map(lambda x: x[0], states), est[0]
            ev = _np.asarray(states.log_evidence)       # [R, E]
            pick = _np.argmax(ev, axis=0)
            e_idx = _np.arange(pick.shape[0])
            fin = jax.tree_util.tree_map(
                lambda x: jnp.asarray(_np.asarray(x)[pick, e_idx]), states)
            return fin, jnp.asarray(_np.asarray(est)[pick, e_idx])
    elif args.replicas > 1:
        run = jax.jit(jax.vmap(lambda k, e, s: slam.run_slam_replicas(
            k, e, s, world.angles, cfg, start,
            replicas=args.replicas)[:2]))
    else:
        run = jax.jit(jax.vmap(lambda k, e, s: slam.run_slam_episode(
            k, e, s, world.angles, cfg, start)))
    rerender_fn = jax.jit(lambda ps, rs: mapping.map_episode(
        ps, rs, world.angles, mc, world.cfg.sensor))

    for slip in args.slip:
        encs, scans, truths = [], [], []
        for ep in range(args.episodes):
            e, s, t = robot.generate_wander_episode(
                jax.random.PRNGKey(args.seed0 + 7919 * ep + 13), m,
                world.cfg, world.angles, args.ticks, start_pose=start,
                slip_noise=slip, explore=True)
            encs.append(np.asarray(e)), scans.append(np.asarray(s))
            truths.append(np.asarray(t))
        enc = jnp.asarray(np.stack(encs))
        sc = jnp.asarray(np.stack(scans))
        tr = np.stack(truths)
        keys = jax.vmap(jax.random.PRNGKey)(
            np.arange(args.episodes) + args.seed0 + 100)
        t0 = time.perf_counter()
        final, est = run(keys, enc, sc)
        jax.block_until_ready(est)
        dt = time.perf_counter() - t0
        est = np.asarray(est)

        slam_err, dr_err, f1s = [], [], []
        for ep in range(args.episodes):
            se = np.hypot(est[ep, :, 0] - tr[ep, :, 0],
                          est[ep, :, 1] - tr[ep, :, 1])[-tail:].mean()
            dr = np.asarray(mapping.dead_reckon_poses(
                enc[ep], start, world.cfg.motion))
            de = np.hypot(dr[:, 0] - tr[ep, :, 0],
                          dr[:, 1] - tr[ep, :, 1])[-tail:].mean()
            if args.map_est == "rerender":
                lo = np.asarray(rerender_fn(jnp.asarray(est[ep]),
                                            sc[ep]))
            elif args.map_est == "consensus":
                lo = np.einsum("p,phw->hw", np.asarray(final.weights[ep]),
                               np.asarray(final.logodds[ep]))
            else:
                lo = np.asarray(final.logodds[ep])[
                    int(np.argmax(np.asarray(final.scores[ep])))]
            fkw = ({} if args.offset_tol is None
                   else dict(offset_tol=args.offset_tol))
            walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                            return_explored=True, **fkw)
            f1 = mapping.wall_metrics(walls, np.asarray(m.walls),
                                      mask=seen)["f1"]
            slam_err.append(se), dr_err.append(de), f1s.append(f1)
            if args.per_episode:
                print(f"  ep{ep:02d}: slam {se:.3f} dr {de:.3f} "
                      f"F1 {f1:.3f}", flush=True)
        slam_err, dr_err = np.asarray(slam_err), np.asarray(dr_err)
        beats = int((slam_err < dr_err).sum())
        print(f"slip={slip:.2f} world={args.world or 'default'} "
              f"K={args.candidates} reps={args.replicas} "
              f"closure={'on' if args.closure else 'off'} "
              f"kf=({args.keyframe_trans},{args.keyframe_rot}) "
              f"P={args.particles} T={args.ticks}: "
              f"slam {slam_err.mean():.3f}/{np.percentile(slam_err, 90):.3f}"
              f"/{slam_err.max():.3f} m | "
              f"dr {dr_err.mean():.3f}/{np.percentile(dr_err, 90):.3f}"
              f"/{dr_err.max():.3f} | beats {beats}/{args.episodes} | "
              f"F1 {np.mean(f1s):.3f} (min {np.min(f1s):.3f}) | "
              f"{dt:.1f}s", flush=True)


if __name__ == "__main__":
    main()
