"""Bisect the MCL step cost: ONE variant per process (so one variant's
compiled executables and allocations cannot skew another's timing).

Usage: python tools/bisect_step.py <variant> [--particles N] [--beams B]
       [--ray-mode fixed|analytic] [--iters I]

Variants: motion, weights, resample, cluster (cumulative stage prefixes),
          full (mcl_step), res_lib (motion+weights+library resample), and
          resample-internals knockouts res_noidx /
          res_barrier / res_nogather / res_nofresh / res_nojitter.
"""
from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variant")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--ray-mode", default="fixed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--resample", default="systematic")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from montecarlolocalisation.config import (
        FilterConfig, ResampleConfig, SensorModelConfig,
    )
    from montecarlolocalisation.maps import from_map_file
    from montecarlolocalisation.models import (
        cluster, filter as mcl, motion, resample, sensor,
    )

    maze = from_map_file(osp.join(
        osp.dirname(osp.abspath(__file__)), "..",
        "montecarlolocalisation", "maps", "default_map.txt"))
    n = args.particles
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
    cfg = FilterConfig(num_particles=n,
                       sensor=SensorModelConfig(ray_mode=args.ray_mode),
                       resample=ResampleConfig(method=args.resample))
    state = mcl.init_state(jax.random.PRNGKey(0), maze, cfg)
    scan0 = sensor.simulate_scan(
        maze, jnp.array([1.25, 1.25, 0.0]), angles, cfg.sensor)

    v = args.variant
    stages = dict(
        motion=("motion",),
        weights=("motion", "weights"),
        resample=("motion", "weights", "resample"),
        cluster=("motion", "weights", "resample", "cluster"),
    ).get(v)

    if v == "full":
        @jax.jit
        def step(state, el, er, ranges):
            sc = sensor.Scan(angles=jnp.asarray(angles), ranges=ranges,
                             mask=jnp.ones_like(ranges, dtype=bool))
            return mcl.mcl_step(state, el, er, sc, maze, cfg)[0]
    elif stages is not None:
        @jax.jit
        def step(state, el, er, ranges):
            sc = sensor.Scan(angles=jnp.asarray(angles), ranges=ranges,
                             mask=jnp.ones_like(ranges, dtype=bool))
            key, k_m, k_r, k_c = jax.random.split(state.key, 4)
            parts, w, odom, inj = (state.particles, state.weights,
                                   state.odom, state.inj)
            conf, best = state.confidence, state.best_pose
            if "motion" in stages:
                odom, parts = motion.motion_update(
                    k_m, parts, odom, el, er, cfg.motion)
            if "weights" in stages:
                w = sensor.beam_weights(maze, parts, sc, cfg.sensor,
                                        cfg.valid_pos_offset)
            if "resample" in stages:
                parts, w, inj, _ = resample.resample(
                    k_r, parts, w, inj, state.was_lost, maze, cfg)
            if "cluster" in stages:
                conf, best = cluster.cluster_confidence(
                    k_c, parts, w, state.confident_threshold, cfg.cluster)
            return mcl.MCLState(
                particles=parts, weights=w, odom=odom, inj=inj,
                confidence=conf, was_lost=state.was_lost,
                cluster_threshold=state.cluster_threshold,
                confident_threshold=state.confident_threshold,
                best_pose=best, key=key)
    elif v == "res_lib":
        @jax.jit
        def step(state, el, er, ranges):
            sc = sensor.Scan(angles=jnp.asarray(angles), ranges=ranges,
                             mask=jnp.ones_like(ranges, dtype=bool))
            key, k_m, k_r, k_c = jax.random.split(state.key, 4)
            odom, parts = motion.motion_update(
                k_m, state.particles, state.odom, el, er, cfg.motion)
            w = sensor.beam_weights(maze, parts, sc, cfg.sensor,
                                    cfg.valid_pos_offset)
            parts, w, inj, _ = resample.resample(
                k_r, parts, w, state.inj, state.was_lost, maze, cfg)
            return mcl.MCLState(
                particles=parts, weights=w, odom=odom, inj=inj,
                confidence=state.confidence, was_lost=state.was_lost,
                cluster_threshold=state.cluster_threshold,
                confident_threshold=state.confident_threshold,
                best_pose=state.best_pose, key=key)
    elif v.startswith("res_"):
        sub = v[4:]  # knockout: full, noidx, nogather, nofresh, nojitter
        from montecarlolocalisation.utils.angles import normalize_angle

        @jax.jit
        def step(state, el, er, ranges):
            sc = sensor.Scan(angles=jnp.asarray(angles), ranges=ranges,
                             mask=jnp.ones_like(ranges, dtype=bool))
            key, k_m, k_r, k_c = jax.random.split(state.key, 4)
            odom, parts = motion.motion_update(
                k_m, state.particles, state.odom, el, er, cfg.motion)
            w = sensor.beam_weights(maze, parts, sc, cfg.sensor,
                                    cfg.valid_pos_offset)
            rcfg = cfg.resample
            total = jnp.sum(w)
            w_avg = total / n
            p = resample._regime(state.was_lost, rcfg)
            w_slow = state.inj.w_slow + p["alpha_slow"] * (
                w_avg - state.inj.w_slow)
            w_fast = state.inj.w_fast + p["alpha_fast"] * (
                w_avg - state.inj.w_fast)
            p_inject = jnp.where(
                w_slow > 0.0, jnp.maximum(0.0, 1.0 - w_fast / w_slow), 0.0)
            norm_w = jnp.where(total > 0.0, w / total, 1.0 / n)
            cdf = jnp.cumsum(norm_w)
            k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(
                k_r, 6)
            u0 = jax.random.uniform(k_draw, ())
            inject_r = jax.random.uniform(k_inj, (n,))
            if sub == "noidx":
                idx = jnp.minimum(
                    jnp.arange(n, dtype=jnp.int32),
                    (cdf[-1] * n).astype(jnp.int32))
            elif sub == "barrier":
                cdf = jax.lax.optimization_barrier(cdf)
                idx = resample.systematic_indices(cdf, u0)
                idx = jax.lax.optimization_barrier(idx)
            else:
                idx = resample.systematic_indices(cdf, u0)
            bern = inject_r < p_inject
            inject = bern & (jnp.cumsum(bern) <= p["max_injection"])
            n_injected = jnp.sum(inject)
            if sub == "nogather":
                drawn = parts
            else:
                drawn = parts[idx]
            if sub != "nojitter":
                jx = jax.random.uniform(
                    k_jx, (n,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
                jy = jax.random.uniform(
                    k_jy, (n,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
                jt = jax.random.uniform(
                    k_jt, (n,), minval=-1.0, maxval=1.0) * p["jitter_theta"]
                drawn = jnp.stack(
                    [drawn[:, 0] + jx, drawn[:, 1] + jy,
                     normalize_angle(drawn[:, 2] + jt)], axis=-1)
            if sub == "nofresh":
                parts = drawn
            else:
                fresh = resample.sample_uniform_particles(
                    k_fresh, maze, n, cfg.init)
                parts = jnp.where(inject[:, None], fresh, drawn)
            parts = parts + 0.0 * n_injected.astype(jnp.float32)
            return mcl.MCLState(
                particles=parts,
                weights=jnp.full((n,), 1.0 / n, dtype=jnp.float32),
                odom=odom, inj=resample.InjectionState(w_slow, w_fast),
                confidence=state.confidence,
                was_lost=state.was_lost,
                cluster_threshold=state.cluster_threshold,
                confident_threshold=state.confident_threshold,
                best_pose=state.best_pose, key=key)
    else:
        sys.exit(f"unknown variant {v!r}")

    enc = jnp.float32(0.1)
    st = step(state, enc, enc, scan0.ranges)
    jax.block_until_ready(st.particles)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        st = step(st, enc, enc, scan0.ranges)
    jax.block_until_ready(st.particles)
    ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(f"{v} {args.ray_mode} N={n} B={args.beams}: {ms:.2f} ms")


if __name__ == "__main__":
    main()
