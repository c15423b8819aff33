"""Convergence vs particle count at fixed compute budget (BASELINE config 4).

Sweeps 1024 global-localization episodes x 300 ticks on the default maze
for a range of particle counts, reporting the alias-aware convergence
fraction and RMSE — the measured answer to "how many particles does this
maze need" (the reference hand-picked 1500 for a Pi 4; monte_carlo.cpp:84).

Default resampling is "systematic" (the production path).  The reference
"multinomial" parity path runs with `--method multinomial`;
`--tick-chunk K` splits the tick scan into host-synced segments
(bit-identical).

Run: python tools/convergence_study.py [--batch 1024] [--ticks 300]
"""
import argparse
import dataclasses
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--particles", type=int, nargs="*",
                    default=[100, 250, 500, 1000, 2000, 4000])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--tick-chunk", type=int, default=None)
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="gradient-guided refinement rounds per tick "
                         "(models/refine) — reproduces the BENCH_DETAILS "
                         "refinement table (e.g. --particles 250 "
                         "--refine-iters 2)")
    ap.add_argument("--ray-mode", default="fixed",
                    choices=["fixed", "dda", "analytic"])
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5): the "
                         "production SIR schedule.  Combine with "
                         "--refine-iters 2 for the composed production "
                         "config at sweep scale")
    args = ap.parse_args()

    from montecarlolocalisation import presets

    for n in args.particles:
        world = presets.make_world(num_particles=n,
                                   ray_mode=args.ray_mode,
                                   refine_iters=args.refine_iters,
                                   ess_threshold=args.ess)
        cfg = dataclasses.replace(
            world.cfg, resample=dataclasses.replace(
                world.cfg.resample, method=args.method))
        world = dataclasses.replace(world, cfg=cfg)
        t0 = time.time()
        metrics = presets.run_sweep(world, batch=args.batch,
                                    num_ticks=args.ticks, seed=args.seed,
                                    tick_chunk=args.tick_chunk)
        print(json.dumps(dict(
            particles=n, batch=args.batch, ticks=args.ticks,
            method=args.method, refine=args.refine_iters, ess=args.ess,
            wall_s=round(time.time() - t0, 1),
            **{k: round(float(v), 4) for k, v in metrics.items()})),
            flush=True)


if __name__ == "__main__":
    main()
