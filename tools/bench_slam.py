"""RBPF SLAM throughput on the chip (models/slam.py).

One SLAM tick = motion proposal + per-particle likelihood field
(blur matmuls) + bilinear endpoint/free-space weighting + ESS-gated
map-carrying resample + vmapped dense map update.  Reports ticks/s for a
range of particle counts, a vmapped SLAM fleet (E robots' episodes in one
device program), and optionally an oversized grid (the field/update
windows should keep the per-tick cost ~flat in map area).

    python tools/bench_slam.py --particles 32 64 128 --ticks 300
    python tools/bench_slam.py --particles 64 --map-px 249 257
"""
import argparse
import os.path as osp
import sys
import time

import jax
import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[32, 64, 128])
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--fleet", type=int, default=8,
                    help="vmapped SLAM robots for the fleet row (0 = skip)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--map-px", type=int, nargs=2, default=None,
                    metavar=("H", "W"))
    args = ap.parse_args()

    from montecarlolocalisation import presets
    from montecarlolocalisation.config import MappingConfig, SLAMConfig
    from montecarlolocalisation.models import slam
    from montecarlolocalisation.sim import robot

    world = presets.make_world(num_beams=args.beams)
    m = world.maze
    if args.map_px:
        mc = MappingConfig(height=args.map_px[0], width=args.map_px[1],
                           resolution=float(m.resolution),
                           origin_x=float(m.origin_x),
                           origin_y=float(m.origin_y))
    else:
        mc = MappingConfig(height=m.height, width=m.width,
                           resolution=float(m.resolution),
                           origin_x=float(m.origin_x),
                           origin_y=float(m.origin_y))
    start = (1.25, 1.25, 0.0)
    enc, scans, _ = robot.generate_wander_episode(
        jax.random.PRNGKey(0), m, world.cfg, world.angles, args.ticks,
        start_pose=start, slip_noise=0.03, explore=True)
    jax.block_until_ready(scans)

    def timed(fn, *xs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*xs))
        t_first = time.perf_counter() - t0
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*xs))
            best = min(best, time.perf_counter() - t0)
        return t_first, best

    size = f"{mc.height}x{mc.width}px"
    for p in args.particles:
        cfg = SLAMConfig(num_particles=p, mapping=mc,
                         sensor=world.cfg.sensor, motion=world.cfg.motion)
        fn = jax.jit(lambda k, e, s, cfg=cfg: slam.run_slam_episode(
            k, e, s, world.angles, cfg, start)[1])
        t_first, best = timed(fn, jax.random.PRNGKey(1), enc, scans)
        print(f"P={p:4d} {size} map: {args.ticks} ticks in {best:.3f}s "
              f"-> {args.ticks / best:,.0f} SLAM ticks/s "
              f"(compile+first {t_first:.1f}s)", flush=True)

    if args.fleet:
        cfg = SLAMConfig(num_particles=64, mapping=mc,
                         sensor=world.cfg.sensor, motion=world.cfg.motion)
        e_n = args.fleet
        keys = jax.vmap(jax.random.PRNGKey)(np.arange(e_n))
        enc_b = np.broadcast_to(np.asarray(enc), (e_n,) + enc.shape)
        sc_b = np.broadcast_to(np.asarray(scans), (e_n,) + scans.shape)
        fn = jax.jit(jax.vmap(lambda k, e, s: slam.run_slam_episode(
            k, e, s, world.angles, cfg, start)[1]))
        t_first, best = timed(fn, keys, enc_b, sc_b)
        total = e_n * args.ticks
        print(f"fleet {e_n} x P=64 {size}: {total} robot-ticks in "
              f"{best:.3f}s -> {total / best:,.0f} SLAM robot-ticks/s "
              f"(compile+first {t_first:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
