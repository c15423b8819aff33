"""Exploration sweep: frontier explorer vs blind wanderer at EQUAL tick
budgets on generated worlds (r3 verdict #6).

The frontier explorer (sim/frontier) merely matched the scripted
wanderer on the small aliased default maze; its claimed advantage is
worlds where blind walks dead-end — BSP office layouts
(maps/generator.generate_rooms: rooms with single doors) are that
regime.  This measures it: for each generated world and seed, both
modes get the SAME total tick budget and the SAME slip/scan noise, and
we record edge-coverage-vs-ticks (fraction of (cell, edge) slots
observed, mapping.fit_walls seen mask), ticks to reach a coverage
threshold, and final explored-edge wall F1.

    python tools/explore_sweep.py --maps 8 --seeds-per-map 2 \
        --rows 6 --cols 6 --ticks 2400 --slip 0.03

Both arms run the SAME RBPF SLAM (models/slam, keyframe gating on, the
slam preset defaults); only the behavior differs:
  * wander   — the reference-style freer-side scripted wanderer
               (sim/robot.generate_wander_episode explore=True,
               wanderer_try_final.cpp:167-191 semantics), SLAM folded
               over the log in tick chunks so coverage is sampled at
               the same checkpoints as the frontier phases;
  * frontier — closed-loop frontier-driven exploration steered by the
               SLAM posterior itself (sim/frontier.run_frontier_slam,
               phase_ticks == the chunk size).
"""
import argparse
import json
import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--seeds-per-map", type=int, default=2)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--style", choices=["rooms", "maze"], default="rooms")
    ap.add_argument("--ticks", type=int, default=2400)
    ap.add_argument("--chunk", type=int, default=120,
                    help="coverage checkpoint interval == frontier phase")
    ap.add_argument("--slip", type=float, default=0.03)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--cov-thresh", type=float, default=0.9)
    ap.add_argument("--frontier-speed", type=float, default=8.0,
                    help="frontier base wheel speed (chip-tuned 8; the "
                         "wanderer's 0.04 m/tick straight-line ~= 12)")
    ap.add_argument("--frontier-turn", type=float, default=5.0)
    ap.add_argument("--arms", nargs="+",
                    default=["wander", "frontier", "hybrid"],
                    choices=["wander", "frontier", "hybrid", "nwander",
                             "nhybrid", "wallfollow"],
                    help="behaviors to sweep; 'hybrid' wanders while "
                         "coverage grows, frontier-targets pockets after "
                         "it saturates (sim/frontier policy='hybrid')")
    ap.add_argument("--kf-trans", type=float, default=0.10)
    ap.add_argument("--kf-rot", type=float, default=0.35)
    ap.add_argument("--seed0", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import (FilterConfig,
                                                   MappingConfig, SLAMConfig)
    from montecarlolocalisation.maps import generator
    from montecarlolocalisation.maps.grid import from_walls
    from montecarlolocalisation.models import mapping, slam
    from montecarlolocalisation.sim import frontier, robot

    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
    fcfg = FilterConfig(num_particles=args.particles)
    start = (1.25, 1.25, 0.0)
    gen = (generator.generate_rooms if args.style == "rooms"
           else generator.generate_maze)
    phases = max(args.ticks // args.chunk, 1)
    n_ckpt = phases + 1

    # One compilation per program across ALL same-shape worlds: the maze
    # rides as a traced pytree argument (wander generation + frontier
    # phases), and the SLAM chunk runner never sees the true map at all.
    first = from_walls(gen(args.rows, args.cols, seed=args.seed0 + 1000))
    mc = MappingConfig(height=first.height, width=first.width,
                       resolution=float(first.resolution),
                       origin_x=float(first.origin_x),
                       origin_y=float(first.origin_y))
    scfg = SLAMConfig(num_particles=args.particles, mapping=mc,
                      sensor=fcfg.sensor, motion=fcfg.motion,
                      keyframe_trans=args.kf_trans,
                      keyframe_rot=args.kf_rot)
    ja = jnp.asarray(angles)
    gen_jit = jax.jit(lambda k, mt: robot.generate_wander_episode(
        k, mt, fcfg, angles, args.ticks, start_pose=start,
        slip_noise=args.slip, explore=True))

    def chunk_fn(st, e, r):
        def body(s, xs):
            ei, ri = xs
            s, info = slam.slam_step(s, ei[0], ei[1], ri, ja,
                                     jnp.ones_like(ri), scfg)
            return s, info["pose"]
        return jax.lax.scan(body, st, (e, r))

    runner = jax.jit(chunk_fn)

    def coverage_curve_wander(m, scfg, cell_px, seed):
        """Blind-wanderer arm: scripted walk, SLAM over the log in
        chunks; coverage sampled at each chunk boundary."""
        enc, scans, truth = gen_jit(jax.random.PRNGKey(seed), m)
        state = slam.init_slam(jax.random.PRNGKey(seed + 1), start, scfg)
        cov = [0.0]
        for i in range(phases):
            sl = slice(i * args.chunk, (i + 1) * args.chunk)
            state, _ = runner(state, enc[sl], scans[sl])
            lo = np.asarray(slam.best_map(state))
            _, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                        return_explored=True)
            cov.append(float(np.mean(seen)))
        lo = np.asarray(slam.best_map(state))
        walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                        return_explored=True)
        f1 = mapping.wall_metrics(walls, np.asarray(m.walls),
                                  mask=seen)["f1"]
        return np.asarray(cov), f1

    def coverage_curve_frontier(m, scfg, cell_px, seed,
                                policy="frontier", novelty=0.0,
                                style_kw={}):
        fst, finfo = frontier.run_frontier_slam(
            seed, m, scfg, angles, start_pose=start, phases=phases,
            phase_ticks=args.chunk, slip_noise=args.slip, policy=policy,
            base_speed=args.frontier_speed, turn_speed=args.frontier_turn,
            novelty_bias=novelty, **style_kw)
        cov = np.asarray(finfo["coverage"], np.float64)
        # Early full-coverage stop: hold the final value to the budget
        # horizon so checkpoint comparisons stay aligned.
        if len(cov) < n_ckpt:
            cov = np.concatenate(
                [cov, np.full(n_ckpt - len(cov), cov[-1])])
        lo = np.asarray(slam.best_map(fst.slam))
        walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                        return_explored=True)
        f1 = mapping.wall_metrics(walls, np.asarray(m.walls),
                                  mask=seen)["f1"]
        return cov[:n_ckpt], f1

    curves = {a: [] for a in args.arms}
    f1s = {a: [] for a in args.arms}
    t0 = time.perf_counter()
    n_eps = 0
    for mi in range(args.maps):
        m = (first if mi == 0 else
             from_walls(gen(args.rows, args.cols,
                            seed=args.seed0 + 1000 + mi)))
        assert (m.height, m.width) == (first.height, first.width)
        cell_px = int(round(m.cell_meters / m.resolution))
        for si in range(args.seeds_per_map):
            seed = args.seed0 + 7919 * mi + 37 * si
            msg = []
            for arm in args.arms:
                if arm == "wander":
                    cv, f1 = coverage_curve_wander(m, scfg, cell_px, seed)
                else:
                    policy = {"nwander": "wander",
                              "nhybrid": "hybrid"}.get(arm, arm)
                    nov = 1.0 if arm.startswith("n") else 0.0
                    cv, f1 = coverage_curve_frontier(
                        m, scfg, cell_px, seed, policy=policy, novelty=nov,
                        style_kw=(dict(wander_style="wallfollow")
                                  if arm == "wallfollow" else {}))
                curves[arm].append(cv)
                f1s[arm].append(f1)
                msg.append(f"{arm} cov {cv[-1]:.3f} F1 {f1:.3f}")
            n_eps += 1
            print(f"map {mi} seed {si}: " + " | ".join(msg)
                  + f"  [{time.perf_counter() - t0:.0f}s]", flush=True)

    wall_s = time.perf_counter() - t0
    ckpts = sorted({max(phases // 4, 1), max(phases // 2, 1), phases})
    out = dict(style=args.style, rows=args.rows, cols=args.cols,
               maps=args.maps, episodes=n_eps, ticks=args.ticks,
               chunk=args.chunk, slip=args.slip,
               particles=args.particles, wall_s=round(wall_s, 1))
    for arm in args.arms:
        cv = np.stack(curves[arm])            # [E, n_ckpt]
        for p in ckpts:
            out[f"{arm}_cov@{p * args.chunk}"] = round(
                float(cv[:, p].mean()), 4)
        out[f"{arm}_cov_final_min"] = round(float(cv[:, -1].min()), 4)
        # ticks to reach the coverage threshold (budget+chunk if never).
        reach = np.argmax(cv >= args.cov_thresh, axis=1).astype(float)
        never = ~(cv >= args.cov_thresh).any(axis=1)
        reach[never] = phases + 1
        out[f"{arm}_reach{args.cov_thresh}_frac"] = round(
            float((~never).mean()), 4)
        out[f"{arm}_reach{args.cov_thresh}_ticks_med"] = round(
            float(np.median(reach) * args.chunk), 1)
        out[f"{arm}_f1"] = round(float(np.mean(f1s[arm])), 4)
    if "wander" in curves:
        for arm in args.arms:
            if arm == "wander":
                continue
            wins = sum(cf[-1] > cw[-1] for cw, cf in
                       zip(curves["wander"], curves[arm]))
            out[f"{arm}_wins_final_cov"] = f"{wins}/{n_eps}"
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
