"""Fleet-mapping throughput on the chip: vmapped occupancy-grid mappers.

E independent robots' episodes fold into E maps in one device program
(vmap over models/mapping.map_episode).  Reports mapping ticks/s — one
tick = one scan's dense inverse-sensor-model update (H x W x B).

    python tools/bench_mapping.py --episodes 256 --ticks 600 --beams 34
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
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--map-px", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="oversize the mapping grid (the maze sits in its "
                         "corner) — the sensor-window scaling check: "
                         "per-tick cost should stay ~flat in map area "
                         "(mapping.update_map dynamic_slice window)")
    args = ap.parse_args()

    from montecarlolocalisation.config import FilterConfig, MappingConfig
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.models import mapping
    from montecarlolocalisation.parallel import episodes

    m = from_map_file(osp.join(osp.dirname(osp.abspath(__file__)), "..",
                               "montecarlolocalisation", "maps",
                               "default_map.txt"))
    cfg = FilterConfig(num_particles=64)
    angles = np.deg2rad(np.linspace(-118, 118, args.beams)).astype(np.float32)
    if args.map_px:
        mc = MappingConfig(height=args.map_px[0], width=args.map_px[1])
    else:
        mc = MappingConfig()

    t0 = time.perf_counter()
    enc, scans, poses = episodes.simulate_episode_batch(
        jax.random.PRNGKey(0), m, cfg, angles, args.ticks, args.episodes,
        start_pose=(2.05, 2.05, 0.0))
    jax.block_until_ready(scans)
    t_sim = time.perf_counter() - t0

    fn = jax.jit(jax.vmap(
        lambda p, s: mapping.map_episode(p, s, angles, mc, cfg.sensor)))
    t0 = time.perf_counter()
    lo = jax.device_get(fn(poses, scans))
    t_compile = time.perf_counter() - t0
    best = float("inf")
    for _ in range(args.iters):
        t0 = time.perf_counter()
        lo = jax.device_get(fn(poses, scans))
        best = min(best, time.perf_counter() - t0)
    ticks = args.episodes * args.ticks
    fused = mapping.fuse_maps(jnp.asarray(lo))
    print(f"sim {t_sim:.1f}s, compile+first {t_compile:.1f}s")
    print(f"{args.episodes} mappers x {args.ticks} ticks x {args.beams} "
          f"beams: {best:.3f}s -> {ticks / best:,.0f} mapping ticks/s "
          f"({ticks * mc.height * mc.width * args.beams / best:.3g} "
          f"pixel-beam evals/s); explored_frac="
          f"{float(jnp.mean(jnp.abs(fused) > 0.5)):.3f}")


if __name__ == "__main__":
    main()
