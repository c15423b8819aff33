"""Randomized-maps sweep driver (BASELINE config 4's maps axis).

vmaps the full filter over generated worlds x episodes (traced maps ->
one-hot lookup path) and prints one JSON metrics line.

  python tools/multimap_sweep.py --maps 64 --episodes-per-map 2 \
      --ticks 150 --style mixed
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", type=int, default=64)
    ap.add_argument("--episodes-per-map", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--style", default="maze",
                    choices=["maze", "rooms", "mixed"])
    ap.add_argument("--extra-openings", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from montecarlolocalisation.config import (FilterConfig,
                                                   SensorModelConfig)
    from montecarlolocalisation.maps import generator
    from montecarlolocalisation.parallel import episodes

    cfg = FilterConfig(num_particles=args.particles,
                       sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, args.beams)
                        ).astype(np.float32)
    maps = generator.generate_map_batch(
        args.maps, rows=args.rows, cols=args.cols, seed=args.seed,
        extra_openings=args.extra_openings, style=args.style)
    t0 = time.time()
    final, outs, truth = episodes.run_multimap_sweep(
        jax.random.PRNGKey(args.seed), maps, cfg, angles, args.ticks,
        episodes_per_map=args.episodes_per_map,
        start_pose=(1.25, 1.25, 0.0))
    metrics = episodes.sweep_rmse(final, truth)
    metrics = {k: round(float(v), 4) for k, v in metrics.items()}
    metrics.update(maps=args.maps, episodes_per_map=args.episodes_per_map,
                   ticks=args.ticks, style=args.style,
                   wall_s=round(time.time() - t0, 1),
                   device=str(jax.devices()[0]))
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
