"""Profiling & stage timing.

The reference instruments its hot loops with manual chrono spans logged to
ROS_INFO (computeWeight/resample/k-means/tick — monte_carlo.cpp:625,678,
556,943,1093; values never recorded).  Here timing is a first-class harness:

  * time_fn        — compile-once, block-until-ready wall timing
  * stage_times    — per-stage breakdown of the MCL tick
  * trace          — context manager around jax.profiler for TensorBoard
                     traces of the real device execution
  * scope_device_times — device time per jax.named_scope, reduced from
                     such a trace (the stages of filter.mcl_step carry
                     the scopes motion / weights / resample / cluster)
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import os
import re
import time
from typing import Callable, Dict, Iterable

import jax


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1) -> float:
    """Mean wall seconds per call (fn jit-compiled by caller)."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_HLO_LINE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def _kernel_key(name: str) -> str:
    # GPU kernels are named after their HLO instruction with "." and "-"
    # turned into "_" (loop_add_fusion.5 -> loop_add_fusion_5).
    return name.replace(".", "_").replace("-", "_")


def hlo_op_names(hlo_text: str) -> Dict[str, str]:
    """{kernel name: metadata op_name} of an optimized HLO module
    (`jitted.lower(...).compile().as_text()`).  A fusion carries the
    op_name of its root, which holds the enclosing named scopes."""
    out = {}
    for line in hlo_text.splitlines():
        mt = _HLO_LINE.match(line)
        if mt:
            out[_kernel_key(mt.group(1))] = mt.group(2)
    return out


def _newest_xplane(logdir: str) -> str:
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return paths[-1]


def device_kernel_events(logdir: str):
    """[(kernel name, hlo_op, start_ns, duration_ns)] of every kernel and
    copy that ran on a GPU in the newest trace under `logdir`.

    Events are read from the per-stream lines of each "/device:GPU:k"
    plane; summary lines, where present, would count them twice.
    `hlo_op` is the event's hlo_op stat ("command_buffer" for kernels
    launched from a CUDA graph), else its name.
    """
    pd = jax.profiler.ProfileData.from_file(_newest_xplane(logdir))
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op", ev.name)
                out.append((ev.name, str(op), ev.start_ns, ev.duration_ns))
    return out


def busy_ns(events) -> float:
    """Union length of the events' [start, start + duration) intervals."""
    total, end = 0.0, float("-inf")
    for _, _, t0, dur in sorted(events, key=lambda e: e[2]):
        t1 = t0 + dur
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def scope_device_times(logdir: str, hlo_text: str,
                       scopes: Iterable[str]) -> Dict[str, float]:
    """Summed device seconds per named scope in the newest trace.

    Each kernel is matched to its HLO instruction by name (the hlo_op
    stat as fallback) and attributed to the first of `scopes` that
    appears as a path component of the instruction's op_name (for a
    Pallas kernel, which no instruction names: as a word of its kernel
    name); copies and unmatched kernels go to "other".  Also returns
    "total" (sum of kernel durations) and "busy" (their union on the
    device clock).
    """
    names = hlo_op_names(hlo_text)
    scopes = list(scopes)
    acc = collections.defaultdict(float)
    events = device_kernel_events(logdir)
    for name, op, _, dur in events:
        op_name = names.get(_kernel_key(name)) or names.get(_kernel_key(op))
        # A Pallas kernel runs under the name it was given, which no HLO
        # instruction carries; its words then name the scope
        # ("beam_weights" -> weights).
        parts = op_name.split("/") if op_name else name.split("_")
        tag = next((sc for sc in scopes if sc in parts), "other")
        acc[tag] += dur * 1e-9
        acc["total"] += dur * 1e-9
    acc["busy"] = busy_ns(events) * 1e-9
    return dict(acc)


def _knockout_step(m, cfg, scan, st, enc, skip):
    """One mcl_step with the `skip` stages replaced by trivial dependent
    stand-ins.  With skip=() this MUST reproduce models.filter.mcl_step
    bit-exactly (same key splits, stage order, state wiring) — pinned by
    tests/test_ops.py::test_stage_knockout_full_matches_mcl_step so a
    future mcl_step refactor cannot silently desynchronize the profiler.
    """
    import jax.numpy as jnp

    from ..models import cluster, filter as mcl, motion, resample, sensor

    n = st.particles.shape[0]
    key, k_m, k_r, k_c = jax.random.split(st.key, 4)
    was_lost, cluster_thr, conf_thr, _, _ = mcl._hysteresis(st, m, cfg)
    if "motion" in skip:
        odom, parts = st.odom, st.particles
    else:
        odom, parts = motion.motion_update(
            k_m, st.particles, st.odom, enc, enc, cfg.motion)
    if "weights" in skip:
        w = parts[:, 0] * 1e-6
    else:
        w = sensor.beam_weights(m, parts, scan, cfg.sensor,
                                cfg.valid_pos_offset)
    if "resample" in skip:
        parts2 = parts + w[:, None] * 0.0
        w2 = jnp.full((n,), 1.0 / n, jnp.float32)
        inj = st.inj
    else:
        parts2, w2, inj, _ = resample.resample(
            k_r, parts, w, st.inj, was_lost, m, cfg)
    if "cluster" in skip:
        conf, best = jnp.float32(0.5) + parts2[0, 0] * 0, st.best_pose
    else:
        conf, best = cluster.cluster_confidence(
            k_c, parts2, w2, conf_thr, cfg.cluster)
    return dataclasses.replace(
        st, particles=parts2, weights=w2, odom=odom, inj=inj,
        confidence=conf, was_lost=was_lost, cluster_threshold=cluster_thr,
        confident_threshold=conf_thr, best_pose=best, key=key)


def stage_knockout_times(m, cfg, scan, state,
                         iters: int = 20) -> Dict[str, float]:
    """Stage MARGINALS by composed-step knockout (the reliable breakdown).

    Times the FULL jitted step, then re-times it with each stage replaced
    by a trivial dependent stand-in; `marginal_<stage> = full - without`.
    Unlike `stage_times`' subtractive method, this keeps every measurement
    inside one composed program, so per-dispatch overhead and cross-stage
    fusion don't distort attribution.  `scope_device_times` gives the
    device-side split from a profiler trace instead.
    """
    import jax.numpy as jnp

    enc = jnp.float32(0.1)

    def run(skip):
        f = jax.jit(lambda st: _knockout_step(m, cfg, scan, st, enc, skip))
        st = f(state)
        jax.block_until_ready(st.particles)
        t0 = time.perf_counter()
        for _ in range(iters):
            st = f(st)
        jax.block_until_ready(st.particles)
        return (time.perf_counter() - t0) / iters

    full = run(())
    out = dict(full=full)
    for stage in ("motion", "weights", "resample", "cluster"):
        out[f"marginal_{stage}"] = full - run((stage,))
    return out


def stage_times(m, cfg, scan, state, iters: int = 10) -> Dict[str, float]:
    """Per-stage breakdown of one MCL tick (seconds): motion, weights,
    resample, cluster, full.

    CAVEAT: subtractive timing of separately-jitted prefixes — each jit
    dispatch adds its own overhead and stages lose their fusion context,
    so small stages are OVERSTATED.  Prefer `scope_device_times` or
    `stage_knockout_times` for attribution; this remains for quick
    cumulative-prefix views.
    """
    import jax.numpy as jnp

    from ..models import cluster, filter as mcl, motion, resample, sensor

    enc = jnp.float32(0.1)

    def mw(st):
        _, k_m, k_r, k_c = jax.random.split(st.key, 4)
        odom, parts = motion.motion_update(
            k_m, st.particles, st.odom, enc, enc, cfg.motion)
        w = sensor.beam_weights(m, parts, scan, cfg.sensor,
                                cfg.valid_pos_offset)
        return parts, w, k_r, k_c

    motion_only = jax.jit(lambda st: motion.motion_update(
        jax.random.split(st.key, 4)[1], st.particles, st.odom, enc, enc,
        cfg.motion)[1])
    weights = jax.jit(lambda st: mw(st)[1])

    def res(st):
        parts, w, k_r, _ = mw(st)
        return resample.resample(k_r, parts, w, st.inj, st.was_lost, m,
                                 cfg)[0]

    def clus(st):
        parts, w, k_r, k_c = mw(st)
        p2, w2, inj, _ = resample.resample(k_r, parts, w, st.inj,
                                           st.was_lost, m, cfg)
        return cluster.cluster_confidence(k_c, p2, w2,
                                          st.confident_threshold,
                                          cfg.cluster)[0]

    full = jax.jit(
        lambda st: mcl.mcl_step(st, enc, enc, scan, m, cfg)[0].particles)

    t_motion = time_fn(motion_only, state, iters=iters)
    t_weights = time_fn(weights, state, iters=iters)
    t_resample = time_fn(jax.jit(res), state, iters=iters)
    t_cluster = time_fn(jax.jit(clus), state, iters=iters)
    t_full = time_fn(full, state, iters=iters)
    return dict(
        motion=t_motion,
        weights=t_weights - t_motion,
        resample=t_resample - t_weights,
        cluster=t_cluster - t_resample,
        full=t_full,
    )
