"""SLAM scale table: per-tick cost + compiled memory vs (P, map size).

VERDICT r4 #5: [P, H, W] dense per-particle maps are memory-cubic; this
measures where the windowed update (mapping window + slam.field_windows)
actually holds the per-tick cost flat and what the memory envelope is.

    python tools/slam_scale.py --particles 32 64 128 --worlds 6x6 12x10 16x12
"""
import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[32, 64, 128])
    ap.add_argument("--worlds", nargs="+", default=["6x6", "12x10", "16x12"])
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--ticks-per-dispatch", type=int, default=8)
    args = ap.parse_args()

    from montecarlolocalisation.config import (FilterConfig,
                                                   MappingConfig, SLAMConfig)
    from montecarlolocalisation.maps import generator
    from montecarlolocalisation.maps.grid import from_walls
    from montecarlolocalisation.models import slam
    from montecarlolocalisation.sim import robot

    fcfg = FilterConfig()
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
    ja = jnp.asarray(angles)
    start = (1.25, 1.25, 0.0)
    K = args.ticks_per_dispatch

    for world in args.worlds:
        r, c = (int(v) for v in world.split("x"))
        m = (from_walls(generator.generate_maze(r, c, seed=3))
             if (r, c) != (6, 6) else
             from_walls(generator.generate_maze(6, 6, seed=3)))
        mc = MappingConfig(height=m.height, width=m.width,
                           resolution=float(m.resolution),
                           origin_x=float(m.origin_x),
                           origin_y=float(m.origin_y))
        enc, scans, _ = robot.generate_wander_episode(
            jax.random.PRNGKey(0), m, fcfg, angles, 64,
            start_pose=start, slip_noise=0.08, explore=True)
        enc, scans = jnp.asarray(enc), jnp.asarray(scans)
        for p in args.particles:
            cfg = SLAMConfig(num_particles=p, mapping=mc,
                             sensor=fcfg.sensor, motion=fcfg.motion,
                             keyframe_trans=0.10, keyframe_rot=0.35)

            def chunk(st, e, s):
                def body(ss, xs):
                    ei, ri = xs
                    ss, info = slam.slam_step(ss, ei[0], ei[1], ri, ja,
                                              jnp.ones_like(ri), cfg)
                    return ss, info["pose"]
                return jax.lax.scan(body, st, (e, s))

            st = slam.init_slam(jax.random.PRNGKey(1), start, cfg)
            fn = jax.jit(chunk)
            lowered = fn.lower(st, enc[:K], scans[:K])
            compiled = lowered.compile()
            try:
                ma = compiled.memory_analysis()
                mem = (f"args {ma.argument_size_in_bytes/2**20:.0f} MiB "
                       f"temp {ma.temp_size_in_bytes/2**20:.0f} MiB")
            except Exception:
                mem = "n/a"
            st2, _ = fn(st, enc[:K], scans[:K])
            jax.block_until_ready(st2.logodds)
            t0 = time.perf_counter()
            cur = st
            for _ in range(args.iters):
                cur, _ = fn(cur, enc[:K], scans[:K])
            jax.block_until_ready(cur.logodds)
            ms = (time.perf_counter() - t0) / (args.iters * K) * 1e3
            win = slam.field_window_px(cfg)
            windowed = 2 * win <= min(m.height, m.width)
            print(f"world {world} ({m.height}x{m.width}px) P={p:4d}: "
                  f"{ms:7.2f} ms/tick | maps "
                  f"{p*m.height*m.width*4/2**20:6.1f} MiB | {mem} | "
                  f"field windowed={windowed} ({win}px)", flush=True)


if __name__ == "__main__":
    main()
