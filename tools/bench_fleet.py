"""Fleet-serving throughput: robots/chip at the reference's own config.

Measures MCLFleetServer tick latency (full host->device->host loop, the
real serving path: one packed frame upload, one vmapped step, one output
fetch) at 1500 particles x 34 beams per robot — the reference's exact
per-robot workload (monte_carlo.cpp:84, 10 Hz on a Pi 4) — for a range of
fleet sizes.  A fleet is "served at 10 Hz" when tick latency < 100 ms.

Usage: python tools/bench_fleet.py [--robots 1 16 64 256] [--ticks 20]
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.io.fleet import MCLFleetServer
from montecarlolocalisation.maps import from_map_file

DEFAULT_MAP = osp.join(osp.dirname(osp.abspath(__file__)), "..",
                       "montecarlolocalisation", "maps",
                       "default_map.txt")


def bench_one(m, n_robots: int, particles: int, beams: int,
              ticks: int, pipeline: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.models import sensor

    cfg = FilterConfig(num_particles=particles, sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, beams)).astype(np.float32)
    fleet = MCLFleetServer(m, cfg, angles, n_robots=n_robots, seed=0,
                           pipeline=pipeline)
    scan = sensor.simulate_scan(
        m, jnp.array([1.25, 1.25, 0.0]), jnp.asarray(angles), cfg.sensor)
    ranges = np.broadcast_to(np.asarray(scan.ranges), (n_robots, beams))
    enc = np.full((n_robots,), 0.1, np.float32)

    fleet.tick(enc, enc, ranges)  # compile
    fleet.flush()
    t0 = time.perf_counter()
    for _ in range(ticks):
        fleet.tick(enc, enc, ranges)
    fleet.flush()  # pipelined mode: drain the last in-flight tick
    dt = (time.perf_counter() - t0) / ticks
    return dict(
        robots=n_robots, particles=particles, beams=beams,
        pipeline=pipeline,
        tick_ms=round(dt * 1e3, 2),
        fleet_rate_hz=round(1.0 / dt, 1),
        robot_ticks_per_sec=round(n_robots / dt, 1),
        serves_10hz=bool(dt < 0.1),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, nargs="+",
                    default=[1, 16, 64, 256])
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--pipeline", action="store_true",
                    help="double-buffered ticks (replies lag one tick; "
                         "fetch overlaps device compute)")
    args = ap.parse_args()

    m = from_map_file(DEFAULT_MAP)
    for r in args.robots:
        print(json.dumps(bench_one(m, r, args.particles, args.beams,
                                   args.ticks, pipeline=args.pipeline)),
              flush=True)


if __name__ == "__main__":
    main()
