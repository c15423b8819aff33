"""Benchmark harness: particle-beam updates/sec/chip on the full MCL step.

Prints the device as one JSON line ({"platform", "device_kind",
"device_count"}), then the result as one JSON line: {"metric", "value",
"unit", "vs_baseline"}.  Exits non-zero when JAX finds no accelerator.

Headline metric (BASELINE.md): particle-beam updates per second on one chip
running the COMPLETE filter tick (motion + ray-cast beam likelihood +
adaptive-injection resampling + k-means confidence) at 1M particles x 34
beams, fp32.  The default ray mode is the EXACT closed-form caster
(ops/analytic.py — geometrically exact first hits; pass --ray-mode
fixed for the reference's step-quantized march, the parity mode).  Steps run --scan-chunk at a time under
lax.scan — the framework's production episode form (models/filter
.run_episode) — which amortizes per-dispatch overhead and lets XLA donate
the carried state between steps (--scan-chunk 1 measures the
online-serving form).  vs_baseline is against the reference's implied
ceiling of ~5.1e5 particle-beam updates/s (1500 particles x 34
beams x 10 Hz on a Raspberry Pi 4; BASELINE.md).

Usage: python bench.py [--particles N] [--beams B] [--iters I] [--mode all]
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np

# Reference implied ceiling: 1500 particles x ~34 beams x 10 Hz on a Pi 4.
# (682 beams survive the (-120,120) crop of the 0.352deg LIDAR; every 20th
# -> 34-35 used per update, monte_carlo.cpp:635-650; BASELINE.md's "~12" is
# a miscount.)  We report against the same per-beam workload.
BASELINE_UPDATES_PER_SEC = 1500 * 34 * 10.0


def make_full_step(num_particles: int, num_beams: int,
                   ray_mode: str = "fixed",
                   resample_method: str = "systematic",
                   beam_combine: str = "sum",
                   scan_chunk: int = 1,
                   ess_threshold=None):
    """(jitted step, initial state, scan ranges) of the benchmarked tick:
    `step(state, enc_l, enc_r, ranges)` runs scan_chunk full MCL steps."""
    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import (
        FilterConfig, ResampleConfig, SensorModelConfig,
    )
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.models import filter as mcl
    from montecarlolocalisation.models import sensor

    map_path = osp.join(osp.dirname(osp.abspath(__file__)),
                        "montecarlolocalisation", "maps",
                        "default_map.txt")
    maze = from_map_file(map_path)
    cfg = FilterConfig(
        num_particles=num_particles,
        sensor=SensorModelConfig(ray_mode=ray_mode,
                                 beam_combine=beam_combine),
        resample=ResampleConfig(method=resample_method,
                                ess_threshold=ess_threshold))
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, num_beams)).astype(np.float32)
    state = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    scan = sensor.simulate_scan(
        maze, jnp.array([1.25, 1.25, 0.0]), angles, cfg.sensor)

    # Episode mode (scan_chunk > 1): scan_chunk full steps per dispatch
    # under lax.scan, the framework's production episode/sweep form
    # (run_episode).  This amortizes the per-dispatch host->device
    # overhead and lets XLA donate the carried state between steps.
    @jax.jit
    def step(state, enc_l, enc_r, ranges):
        sc = sensor.Scan(angles=jnp.asarray(angles), ranges=ranges,
                         mask=jnp.ones_like(ranges, dtype=bool))

        def body(st, _):
            return mcl.mcl_step(st, enc_l, enc_r, sc, maze, cfg)[0], None

        return jax.lax.scan(body, state, None, length=scan_chunk)[0]

    return step, state, scan.ranges


def bench_full_step(num_particles: int, num_beams: int, iters: int,
                    ray_mode: str = "fixed",
                    resample_method: str = "systematic",
                    beam_combine: str = "sum",
                    scan_chunk: int = 1,
                    ess_threshold=None) -> dict:
    import jax
    import jax.numpy as jnp

    step, state, ranges = make_full_step(
        num_particles, num_beams, ray_mode, resample_method, beam_combine,
        scan_chunk, ess_threshold)
    enc = jnp.float32(0.1)
    # Warm-up / compile.
    t0 = time.perf_counter()
    state = step(state, enc, enc, ranges)
    jax.block_until_ready(state.particles)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        state = step(state, enc, enc, ranges)
    jax.block_until_ready(state.particles)
    dt = time.perf_counter() - t0

    steps_per_sec = iters * scan_chunk / dt
    updates_per_sec = steps_per_sec * num_particles * num_beams
    return dict(
        steps_per_sec=steps_per_sec,
        updates_per_sec=updates_per_sec,
        seconds_per_step=dt / (iters * scan_chunk),
        compile_s=compile_s,
        finite=bool(jnp.isfinite(state.particles).all()),
        num_particles=num_particles,
        num_beams=num_beams,
        device=str(jax.devices()[0]),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--iters", type=int, default=4,
                    help="timed dispatches (each runs --scan-chunk steps)")
    ap.add_argument("--ray-mode", default="analytic",
                    choices=["fixed", "dda", "analytic"])
    ap.add_argument("--resample", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--beam-combine", default="sum", choices=["sum", "log"])
    ap.add_argument("--scan-chunk", type=int, default=8,
                    help="full steps per dispatch via lax.scan (episode "
                         "mode, the production run_episode form; 1 = one "
                         "dispatch per step, the online-serving form)")
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5): carry "
                         "cumulative weights and resample only when "
                         "ESS < ess*N (production SIR schedule; measures "
                         "tracking-mode throughput).  Default: reference "
                         "schedule, resample every tick")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    import jax

    from montecarlolocalisation.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    dev = jax.devices()[0]
    print(json.dumps(dict(platform=dev.platform, device_kind=dev.device_kind,
                          device_count=len(jax.devices()))), flush=True)
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only the CPU")
    r = bench_full_step(args.particles, args.beams, args.iters,
                        ray_mode=args.ray_mode,
                        resample_method=args.resample,
                        beam_combine=args.beam_combine,
                        scan_chunk=args.scan_chunk,
                        ess_threshold=args.ess)
    if args.verbose:
        print(json.dumps(r, indent=2), file=sys.stderr)
    print(json.dumps(dict(
        metric="particle_beam_updates_per_sec_full_mcl_step",
        value=r["updates_per_sec"],
        unit="updates/s",
        vs_baseline=r["updates_per_sec"] / BASELINE_UPDATES_PER_SEC,
    )))


if __name__ == "__main__":
    main()
