"""Multi-chip MCL: the particle axis sharded over a device mesh.

The reference is a single-process filter over 1500 particles
(monte_carlo.cpp:84); this module scales the SAME step to millions of
particles across chips.  Design (SURVEY.md §2.4):

  * particles [N, 3] and weights [N] are sharded on mesh axis
    `particle_axis`; the map raster is replicated.
  * motion / beam weights / jitter are embarrassingly parallel (local).
  * resampling needs the GLOBAL weight distribution, but NOT the global
    cloud: only [P] scalar prefix sums cross devices up front, then source
    particle blocks rotate around the ring (ppermute) and each shard
    assembles exactly its own N/P output slots from the visiting blocks —
    per-chip memory and expansion compute stay O(N/P)
    (sharded_exchange="ring"; the legacy "allgather" form that replicated
    the whole cloud per shard is kept for A/B parity).  The injection cap
    is global: shard-level Bernoulli counts are all_gathered and converted
    to a global first-come prefix, preserving the reference's
    "first max_injection successes" semantics (monte_carlo.cpp:518-527).
  * k-means runs replicated-centers / sharded-points: assignment is local,
    center updates are psum reductions — no gather of the particle cloud.

Collectives run via shard_map; everything compiles into the one jit
program (no host coordination per tick).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import cluster, filter as mcl, motion, resample, sensor
from ..utils.angles import normalize_angle


def make_mesh(n_particle_shards: Optional[int] = None,
              n_episode_shards: int = 1,
              devices=None) -> Mesh:
    """Build a ('episode', 'particle') mesh over the available devices."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    if n_particle_shards is None:
        n_particle_shards = len(devices) // n_episode_shards
    arr = np.asarray(devices[: n_episode_shards * n_particle_shards]).reshape(
        n_episode_shards, n_particle_shards)
    return Mesh(arr, axis_names=("episode", "particle"))


def _shard_keys(key, axis_name: str):
    """Same base key on every shard -> distinct per-shard key."""
    return jax.random.fold_in(key, jax.lax.axis_index(axis_name))


def _global_cdf_prefix(norm_local, axis_name: str):
    """Global-CDF bookkeeping from a local normalized-weight shard.

    Returns (cdf_local, incl) where cdf_local[i] is the GLOBAL inclusive
    CDF value at local source i and incl[s] is the global CDF at the end
    of shard s's block.  Only [P] scalars cross devices; `incl` is the
    cumsum of the SAME gathered vector on every shard, so block
    boundaries agree globally (no cross-shard fp divergence).
    """
    my = jax.lax.axis_index(axis_name)
    lc = jnp.cumsum(norm_local)
    g = jax.lax.all_gather(lc[-1], axis_name)            # [P], replicated
    incl = jnp.cumsum(g)
    prefix = jnp.where(my > 0, incl[jnp.maximum(my - 1, 0)], 0.0)
    return prefix + lc, incl


def _ring_systematic_draw(particles, norm_local, u0, axis_name: str):
    """Distributed systematic resampling with O(N/P) per-chip footprint.

    Replaces the all_gather-the-cloud + per-shard global expansion
    (the round-3 form this module shipped with): each source shard
    computes its particles' offspring intervals in GLOBAL output
    coordinates (ends_i = clip(floor(N·cdf_i − u0) + 1, 0, N), the same
    closed form as resample.systematic_indices), then source blocks
    rotate around a device ring (P−1 ppermutes).  At each step the
    destination scatters the visiting block's interval starts into its
    own n_loc-slot output block, cummax-fills, and selects — the slots a
    visiting block covers are exactly the global range [blk_lo_j,
    blk_hi_j) it tiles, so each output slot is written by exactly one
    step.  Per-shard peak memory is O(n_loc); no [N_global, 3] array is
    ever materialized (asserted by tests/test_sharding jaxpr check).
    Output is bit-identical to particles_global[systematic_indices(cdf,
    u0)] sliced to this shard (up to cross-shard cumsum rounding at
    block boundaries — prototype-verified exact over adversarial weight
    patterns).  Semantics: monte_carlo.cpp:497-555's CDF inversion in
    the low-variance stratified form.
    """
    n_loc = norm_local.shape[0]
    n_shards = jax.lax.axis_size(axis_name)
    n_global = n_loc * n_shards
    my = jax.lax.axis_index(axis_name)
    base = my * n_loc

    cdf_local, incl = _global_cdf_prefix(norm_local, axis_name)
    ends = jnp.clip(
        jnp.floor(n_global * cdf_local - u0).astype(jnp.int32) + 1,
        0, n_global)
    # Block output boundaries, computed from the SAME replicated [P]
    # vector on every shard -> globally consistent tiling of [0, N).
    blk_hi_all = jnp.clip(
        jnp.floor(n_global * incl - u0).astype(jnp.int32) + 1, 0, n_global)
    blk_hi_all = jax.lax.cummax(blk_hi_all).at[-1].set(n_global)
    blk_lo = jnp.where(my > 0, blk_hi_all[jnp.maximum(my - 1, 0)], 0)
    blk_hi = blk_hi_all[my]
    # Trailing slots fall to the block's last source (same semantics as
    # systematic_indices' cummax fill on a short final interval).
    ends = jnp.clip(jax.lax.cummax(ends), blk_lo, blk_hi).at[-1].set(blk_hi)
    starts = jnp.concatenate([blk_lo[None], ends[:-1]])

    slot = base + jnp.arange(n_loc, dtype=jnp.int32)
    ids = jnp.arange(n_loc, dtype=jnp.int32)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    drawn = jnp.zeros((n_loc, particles.shape[1]), particles.dtype)
    v_starts, v_ends, v_parts = starts, ends, particles
    for r in range(n_shards):
        j = (my - r) % n_shards
        v_lo = jnp.where(j > 0, blk_hi_all[jnp.maximum(j - 1, 0)], 0)
        v_hi = blk_hi_all[j]
        lo = jnp.clip(v_starts - base, 0, n_loc)
        hi = jnp.clip(v_ends - base, 0, n_loc)
        pos = jnp.where(hi > lo, lo, n_loc)              # n_loc -> dropped
        buf = jax.lax.cummax(
            jnp.full((n_loc,), -1, jnp.int32).at[pos].max(ids, mode="drop"))
        vals = v_parts[jnp.clip(buf, 0, n_loc - 1)]
        inr = (slot >= v_lo) & (slot < v_hi)
        drawn = jnp.where(inr[:, None], vals, drawn)
        if r < n_shards - 1:
            v_starts = jax.lax.ppermute(v_starts, axis_name, perm)
            v_ends = jax.lax.ppermute(v_ends, axis_name, perm)
            v_parts = jax.lax.ppermute(v_parts, axis_name, perm)
    return drawn


def _ring_multinomial_draw(key, particles, norm_local, axis_name: str):
    """Distributed multinomial via distributed ORDER STATISTICS, O(N/P).

    The sharded composition of resample.multinomial_indices_sorted (the
    round-3 sorted draw the legacy all_gather path never used): the
    resampled multiset is permutation-invariant, so shard t draws output
    block t directly as the global sorted uniforms U_(t·n_loc .. ) — the
    exponential-spacings construction distributes perfectly (local
    cumsum of Exp(1) + [P]-scalar prefix + global-total normalize).
    Source CDF blocks then rotate around the ring; positions inside a
    visiting block's CDF span cross-rank against it with ONE merged
    sort per step (crossrank_counts — no searchsorted).  Multiset
    distribution identical to iid CDF inversion (monte_carlo.cpp:
    497-555); draw/injection decoupling as in the single-chip sorted
    impl (QUIRKS.md fast-path row).
    """
    n_loc = norm_local.shape[0]
    n_shards = jax.lax.axis_size(axis_name)
    my = jax.lax.axis_index(axis_name)

    # Global sorted uniforms, this shard's block (ascending).
    loc_key = jax.random.fold_in(key, my)
    e = -jnp.log(jax.random.uniform(loc_key, (n_loc,),
                                    minval=jnp.float32(1e-37), maxval=1.0))
    e_extra = -jnp.log(jax.random.uniform(
        jax.random.fold_in(key, n_shards), (),
        minval=jnp.float32(1e-37), maxval=1.0))
    se = jnp.cumsum(e)
    ge = jax.lax.all_gather(se[-1], axis_name)
    incl_e = jnp.cumsum(ge)
    pre_e = jnp.where(my > 0, incl_e[jnp.maximum(my - 1, 0)], 0.0)
    rs = (pre_e + se) / (incl_e[-1] + e_extra)

    cdf_local, incl = _global_cdf_prefix(norm_local, axis_name)

    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    drawn = jnp.zeros((n_loc, particles.shape[1]), particles.dtype)
    v_cdf, v_parts = cdf_local, particles
    for r in range(n_shards):
        j = (my - r) % n_shards
        span_lo = jnp.where(j > 0, incl[jnp.maximum(j - 1, 0)], -jnp.inf)
        span_hi = jnp.where(j == n_shards - 1, jnp.inf, incl[j])
        cnt = resample.crossrank_counts(rs, v_cdf)
        vals = v_parts[jnp.clip(cnt, 0, n_loc - 1)]
        inr = (rs >= span_lo) & (rs < span_hi)
        drawn = jnp.where(inr[:, None], vals, drawn)
        if r < n_shards - 1:
            v_cdf = jax.lax.ppermute(v_cdf, axis_name, perm)
            v_parts = jax.lax.ppermute(v_parts, axis_name, perm)
    return drawn


def resample_sharded(
    key, particles, weights, inj: resample.InjectionState, jitter_state,
    m: MazeMap, cfg: FilterConfig, axis_name: str, draw_weights=None,
):
    """Distributed resampling: identical semantics to resample.resample on
    the concatenated shards (up to RNG stream).  `draw_weights` (local
    shard, optional) feeds the CDF draw while `weights` always feeds the
    injection bookkeeping — same contract as resample.resample."""
    rcfg = cfg.resample
    n_loc = particles.shape[0]
    n_shards = jax.lax.psum(1, axis_name)
    n_global = n_loc * n_shards
    my = jax.lax.axis_index(axis_name)

    local_sum = jnp.sum(weights)
    total = jax.lax.psum(local_sum, axis_name)
    w_avg = total / n_global
    p = resample._regime(jitter_state, rcfg)
    w_slow = inj.w_slow + p["alpha_slow"] * (w_avg - inj.w_slow)
    w_fast = inj.w_fast + p["alpha_fast"] * (w_avg - inj.w_fast)
    p_inject = jnp.where(
        w_slow > 0.0, jnp.maximum(0.0, 1.0 - w_fast / w_slow), 0.0)

    if draw_weights is None:
        draw_weights, draw_total = weights, total
    else:
        draw_total = jax.lax.psum(jnp.sum(draw_weights), axis_name)
    norm_local = jnp.where(draw_total > 0.0, draw_weights / draw_total,
                           1.0 / n_global)

    loc_key = _shard_keys(key, axis_name)
    k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(loc_key, 6)
    if rcfg.sharded_exchange == "ring":
        # O(N/P) offspring exchange: no full-cloud gather, no global-width
        # expansion.  Shard-invariant draw keys (derived from the
        # replicated `key`, counters disjoint from the per-shard
        # loc_key streams above).
        if rcfg.method == "multinomial":
            mn_key = jax.random.split(jax.random.fold_in(key, 0), 8)[7]
            drawn = _ring_multinomial_draw(mn_key, particles, norm_local,
                                           axis_name)
            inject_r = jax.random.uniform(k_inj, (n_loc,))
        else:
            u_key, _ = jax.random.split(jax.random.fold_in(key, 0))
            u0 = jax.random.uniform(u_key, ())  # same on all shards
            drawn = _ring_systematic_draw(particles, norm_local, u0,
                                          axis_name)
            inject_r = jax.random.uniform(k_inj, (n_loc,))
    elif rcfg.sharded_exchange == "allgather":
        # Legacy: replicate the global CDF + cloud per shard (O(N_global)
        # per-chip memory/compute) — kept only for A/B parity checks.
        all_w = jax.lax.all_gather(norm_local, axis_name, tiled=True)
        cdf = jnp.cumsum(all_w)
        all_parts = jax.lax.all_gather(particles, axis_name, tiled=True)
        if rcfg.method == "multinomial":
            r = jax.random.uniform(k_draw, (n_loc,))
            inject_r = r
            idx = jnp.clip(jnp.searchsorted(cdf, r, side="left"), 0,
                           n_global - 1)
        else:  # systematic: stratified global positions, this shard's block
            u_key, _ = jax.random.split(jax.random.fold_in(key, 0))
            u0 = jax.random.uniform(u_key, ())  # same on all shards
            idx_full = resample.systematic_indices(cdf, u0)  # [n_global]
            idx = jax.lax.dynamic_slice(idx_full, (my * n_loc,), (n_loc,))
            inject_r = jax.random.uniform(k_inj, (n_loc,))
        drawn = all_parts[idx]
    else:
        raise ValueError(
            f"unknown sharded_exchange {rcfg.sharded_exchange!r}")

    # Global first-come injection cap.
    bern = inject_r < p_inject
    local_count = jnp.sum(bern.astype(jnp.int32))
    counts = jax.lax.all_gather(local_count, axis_name)       # [P]
    prefix = jnp.sum(jnp.where(jnp.arange(n_shards) < my, counts, 0))
    inject = bern & ((prefix + jnp.cumsum(bern)) <= p["max_injection"])
    n_injected = jax.lax.psum(jnp.sum(inject), axis_name)
    jx = jax.random.uniform(k_jx, (n_loc,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
    jy = jax.random.uniform(k_jy, (n_loc,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
    jt = jax.random.uniform(k_jt, (n_loc,), minval=-1.0, maxval=1.0) * p["jitter_theta"]
    drawn = jnp.stack(
        [drawn[:, 0] + jx, drawn[:, 1] + jy, normalize_angle(drawn[:, 2] + jt)],
        axis=-1)
    fresh = resample.sample_uniform_particles(k_fresh, m, n_loc, cfg.init)
    new_particles = jnp.where(inject[:, None], fresh, drawn)
    new_weights = jnp.full((n_loc,), 1.0 / n_global, dtype=jnp.float32)
    info = dict(p_inject=p_inject, n_injected=n_injected, w_avg=w_avg,
                total_weight=total)
    return new_particles, new_weights, resample.InjectionState(w_slow, w_fast), info


def ess_gated_resample_sharded(
    key, particles, likelihood, carried_w, inj: resample.InjectionState,
    jitter_state, m: MazeMap, cfg: FilterConfig, axis_name: str,
):
    """Sharded ESS-gated SIR (models/resample.ess_gated_resample with all
    reductions as psums).  The gate predicate (global ESS and the kidnap
    detector's injection request) is computed from collectives, so every
    shard takes the same lax.cond branch."""
    n_loc = particles.shape[0]
    n_global = n_loc * jax.lax.psum(1, axis_name)
    tau = cfg.resample.ess_threshold
    combined = carried_w * likelihood
    total_c = jax.lax.psum(jnp.sum(combined), axis_name)
    norm = jnp.where(total_c > 0.0, combined / total_c,
                     jnp.float32(1.0 / n_global))
    ess = 1.0 / jax.lax.psum(jnp.sum(norm * norm), axis_name)

    p = resample._regime(jitter_state, cfg.resample)
    total_l = jax.lax.psum(jnp.sum(likelihood), axis_name)
    w_avg = total_l / n_global
    w_slow = inj.w_slow + p["alpha_slow"] * (w_avg - inj.w_slow)
    w_fast = inj.w_fast + p["alpha_fast"] * (w_avg - inj.w_fast)
    p_inject_now = jnp.where(
        w_slow > 0.0, jnp.maximum(0.0, 1.0 - w_fast / w_slow), 0.0)

    def _do_resample():
        return resample_sharded(key, particles, likelihood, inj,
                                jitter_state, m, cfg, axis_name,
                                draw_weights=norm)

    def _skip():
        info = dict(p_inject=p_inject_now, n_injected=jnp.int32(0),
                    w_avg=w_avg, total_weight=total_l)
        return (particles, norm,
                resample.InjectionState(w_slow, w_fast), info)

    return jax.lax.cond((ess < tau * n_global) | (p_inject_now > 0.0),
                        _do_resample, _skip)


def _global_take(particles, idx, axis_name: str):
    """Pick global particle rows by index, shards holding contiguous blocks."""
    n_loc = particles.shape[0]
    my = jax.lax.axis_index(axis_name)
    local = idx - my * n_loc
    ours = (local >= 0) & (local < n_loc)
    vals = particles[jnp.clip(local, 0, n_loc - 1)]
    vals = jnp.where(ours[..., None], vals, 0.0)
    return jax.lax.psum(vals, axis_name)


def cluster_confidence_sharded(
    key, particles, weights, threshold, cfg, axis_name: str,
    weighted: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Distributed k-means confidence: replicated centers, sharded points.

    Same semantics as cluster.cluster_confidence on the concatenation; all
    reductions are psums, no particle gather.  `weighted=True` is the
    importance-weighted form for the ESS-gated schedule (see
    cluster.cluster_confidence) — coincides with the default under uniform
    weights.
    """
    n_loc = particles.shape[0]
    n_global = n_loc * jax.lax.psum(1, axis_name)
    xy = particles[:, :2]
    k = cfg.k
    k_init, k_iters = jax.random.split(key)  # same on all shards
    init_idx = jax.random.randint(k_init, (k,), 0, n_global)
    centers0 = _global_take(particles, init_idx, axis_name)[:, :2]
    assign0 = jnp.zeros((n_loc,), jnp.int32)
    iter_keys = jax.random.split(k_iters, cfg.max_iters)

    def body(carry, it_key):
        centers, assign, done = carry
        d = xy[:, None, :] - centers[None, :, :]
        new_assign = jnp.argmin(jnp.sum(d * d, axis=-1), axis=-1).astype(jnp.int32)
        changed = jax.lax.psum(
            jnp.sum((new_assign != assign).astype(jnp.int32)), axis_name) > 0
        do_update = changed & ~done
        onehot = jax.nn.one_hot(new_assign, k, dtype=jnp.float32)
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), axis_name)
        sums = jax.lax.psum(
            jnp.matmul(onehot.T, xy, precision=jax.lax.Precision.HIGHEST),
            axis_name)
        means = sums / jnp.maximum(counts[:, None], 1.0)
        reseed_idx = jax.random.randint(it_key, (k,), 0, n_global)
        reseed = _global_take(particles, reseed_idx, axis_name)[:, :2]
        means = jnp.where((counts > 0)[:, None], means, reseed)
        centers = jnp.where(do_update, means, centers)
        assign = jnp.where(do_update, new_assign, assign)
        done = done | ~changed
        return (centers, assign, done), None

    (centers, assign, _), _ = jax.lax.scan(
        body, (centers0, assign0, jnp.bool_(False)), iter_keys)

    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
    cluster_w = jax.lax.psum(
        jnp.matmul(onehot.T, weights, precision=jax.lax.Precision.HIGHEST),
        axis_name)
    best = jnp.argmax(cluster_w)
    cx, cy = centers[best, 0], centers[best, 1]
    member = (assign == best).astype(jnp.float32)
    if weighted:
        w_sum = jnp.maximum(jax.lax.psum(jnp.sum(weights), axis_name),
                            1e-30)
        mw = member * weights
        mw_sum = jnp.maximum(jax.lax.psum(jnp.sum(mw), axis_name), 1e-30)
        cx = jax.lax.psum(jnp.sum(mw * xy[:, 0]), axis_name) / mw_sum
        cy = jax.lax.psum(jnp.sum(mw * xy[:, 1]), axis_name) / mw_sum
        sin_sum = jax.lax.psum(
            jnp.sum(mw * jnp.sin(particles[:, 2])), axis_name)
        cos_sum = jax.lax.psum(
            jnp.sum(mw * jnp.cos(particles[:, 2])), axis_name)
        theta = jnp.arctan2(sin_sum, cos_sum)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        ratio = jax.lax.psum(
            jnp.sum(jnp.where(d2 <= cfg.near_radius**2, weights, 0.0)),
            axis_name) / w_sum
    else:
        sin_sum = jax.lax.psum(
            jnp.sum(member * jnp.sin(particles[:, 2])), axis_name)
        cos_sum = jax.lax.psum(
            jnp.sum(member * jnp.cos(particles[:, 2])), axis_name)
        theta = jnp.arctan2(sin_sum, cos_sum)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        near = jax.lax.psum(
            jnp.sum((d2 <= cfg.near_radius**2).astype(jnp.float32)),
            axis_name)
        ratio = near / n_global
    best_pose = jnp.where(
        ratio > threshold,
        jnp.stack([cx, cy, theta]),
        jnp.full((3,), -1.0, jnp.float32))
    return ratio, best_pose


def mcl_step_sharded(
    state: mcl.MCLState, encoder_left, encoder_right, scan: sensor.Scan,
    m: MazeMap, cfg: FilterConfig, axis_name: str = "particle",
) -> Tuple[mcl.MCLState, mcl.MCLOutput]:
    """One tick with the particle axis sharded on `axis_name`.

    Call inside shard_map with state.particles/weights sharded on
    P(axis_name) and everything else replicated.  Scalars (thresholds,
    confidence, best pose) stay replicated — collectives keep them equal.
    """
    key, k_motion, k_resample, k_cluster = jax.random.split(state.key, 4)

    was_lost, cluster_thr, conf_thr, song, wanderer = mcl._hysteresis(
        state, m, cfg)
    exact_pose = state.best_pose
    cell_pose = mcl.cell_pose_msg(state.best_pose, m.cell_meters)

    # Shared motion noise: same k_motion on all shards -> same noisy triple,
    # matching the reference's one-triple-for-all quirk even across chips.
    # Per-particle mode folds in the shard index.
    k_m = k_motion if cfg.motion.shared_noise else _shard_keys(
        k_motion, axis_name)
    odom, particles = motion.motion_update(
        k_m, state.particles, state.odom, encoder_left, encoder_right,
        cfg.motion)

    # Gradient-guided refinement is purely per-particle (the dense
    # differentiable evaluation has no cross-particle terms), so the local
    # shard refines independently — no collectives needed.
    if cfg.refine.iters > 0:
        from ..models import refine as _refine

        particles = _refine.refine_particles(m, particles, scan, cfg)

    weights = sensor.beam_weights(m, particles, scan, cfg.sensor,
                                  cfg.valid_pos_offset)
    if cfg.resample.ess_threshold is None:
        particles, weights, inj, info = resample_sharded(
            k_resample, particles, weights, state.inj, was_lost, m, cfg,
            axis_name)
    else:
        particles, weights, inj, info = ess_gated_resample_sharded(
            k_resample, particles, weights, state.weights, state.inj,
            was_lost, m, cfg, axis_name)
    confidence, best_pose = cluster_confidence_sharded(
        k_cluster, particles, weights, conf_thr, cfg.cluster, axis_name,
        weighted=cfg.resample.ess_threshold is not None)

    new_state = mcl.MCLState(
        particles=particles, weights=weights, odom=odom, inj=inj,
        confidence=confidence, was_lost=was_lost,
        cluster_threshold=cluster_thr, confident_threshold=conf_thr,
        best_pose=best_pose, key=key)
    out = mcl.MCLOutput(
        exact_pose=exact_pose, cell_pose=cell_pose, confidence=confidence,
        song=song, wanderer_cmd=wanderer,
        n_injected=info["n_injected"].astype(jnp.int32),
        p_inject=info["p_inject"], total_weight=info["total_weight"])
    return new_state, out


def make_sharded_step(mesh: Mesh, m: MazeMap, cfg: FilterConfig,
                      axis_name: str = "particle"):
    """jit-compiled shard_map'd step over `mesh` (particle axis sharded)."""
    from jax import shard_map

    pspec = P(axis_name)
    state_spec = mcl.MCLState(
        particles=P(axis_name), weights=P(axis_name),
        odom=motion.OdometryState(x=P(), y=P(), theta=P(),
                                  encoder_left=P(), encoder_right=P()),
        inj=resample.InjectionState(w_slow=P(), w_fast=P()),
        confidence=P(), was_lost=P(), cluster_threshold=P(),
        confident_threshold=P(), best_pose=P(), key=P())
    out_spec = mcl.MCLOutput(
        exact_pose=P(), cell_pose=P(), confidence=P(), song=P(),
        wanderer_cmd=P(), n_injected=P(), p_inject=P(), total_weight=P())
    map_spec = jax.tree_util.tree_map(lambda _: P(), m)

    def body(state, enc_l, enc_r, angles, ranges, mask, m_arrays):
        scan = sensor.Scan(angles=angles, ranges=ranges, mask=mask)
        return mcl_step_sharded(state, enc_l, enc_r, scan, m_arrays, cfg,
                                axis_name)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, P(), P(), P(), P(), P(), map_spec),
        out_specs=(state_spec, out_spec),
        check_vma=False,
    )

    @jax.jit
    def step(state, enc_l, enc_r, scan: sensor.Scan):
        return fn(state, enc_l, enc_r, scan.angles, scan.ranges, scan.mask, m)

    return step


def make_sharded_step_batched(mesh: Mesh, m: MazeMap, cfg: FilterConfig,
                              episode_axis: str = "episode",
                              particle_axis: str = "particle"):
    """Episode x particle 2D-sharded step: the full scale-out configuration.

    State carries a leading episode axis: particles [E, N, 3] sharded
    P(episode, particle); per-episode scalars [E] sharded P(episode).  Inside
    shard_map the episode block is vmapped and the particle collectives
    (psum/all_gather on `particle_axis`) run per episode — episodes are data
    parallel, particles are model parallel, exactly the SURVEY.md §2.4
    mapping.
    """
    from jax import shard_map

    ep, pp = P(episode_axis), P(episode_axis, particle_axis)
    state_spec = mcl.MCLState(
        particles=P(episode_axis, particle_axis),
        weights=P(episode_axis, particle_axis),
        odom=motion.OdometryState(x=ep, y=ep, theta=ep,
                                  encoder_left=ep, encoder_right=ep),
        inj=resample.InjectionState(w_slow=ep, w_fast=ep),
        confidence=ep, was_lost=ep, cluster_threshold=ep,
        confident_threshold=ep, best_pose=ep, key=ep)
    out_spec = mcl.MCLOutput(
        exact_pose=ep, cell_pose=ep, confidence=ep, song=ep,
        wanderer_cmd=ep, n_injected=ep, p_inject=ep, total_weight=ep)
    map_spec = jax.tree_util.tree_map(lambda _: P(), m)

    def one_episode(state, enc_l, enc_r, angles, ranges, mask, m_arrays):
        scan = sensor.Scan(angles=angles, ranges=ranges, mask=mask)
        return mcl_step_sharded(state, enc_l, enc_r, scan, m_arrays, cfg,
                                particle_axis)

    def body(state, enc_l, enc_r, angles, ranges, mask, m_arrays):
        return jax.vmap(
            lambda st, el, er, rg: one_episode(st, el, er, angles, rg,
                                               mask, m_arrays)
        )(state, enc_l, enc_r, ranges)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, ep, ep, P(), ep, P(), map_spec),
        out_specs=(state_spec, out_spec),
        check_vma=False)

    @jax.jit
    def step(state, enc_l, enc_r, scan: sensor.Scan):
        return fn(state, enc_l, enc_r, scan.angles, scan.ranges, scan.mask, m)

    return step


def init_batched_state(key, m: MazeMap, cfg: FilterConfig,
                       num_episodes: int) -> mcl.MCLState:
    """vmap init_state over an episode batch (host-side; shard with
    jax.device_put + NamedSharding afterwards)."""
    keys = jax.random.split(key, num_episodes)
    return jax.vmap(lambda k: mcl.init_state(k, m, cfg))(keys)


def shard_state(state: mcl.MCLState, mesh: Mesh,
                axis_name: str = "particle",
                episode_axis: str = None) -> mcl.MCLState:
    """Place a host state onto the mesh with the particle axis sharded.

    With `episode_axis` set, the state is the episode-batched layout
    (leading [E] axis on every field; particles/weights also sharded on
    `axis_name`) used by make_sharded_step_batched — this function is the
    one place that knows the field-by-field sharding.
    """
    lead = (episode_axis,) if episode_axis else ()
    p_spec = P(*lead, axis_name)
    s_spec = P(*lead)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return mcl.MCLState(
        particles=put(state.particles, p_spec),
        weights=put(state.weights, p_spec),
        odom=jax.tree_util.tree_map(lambda x: put(x, s_spec), state.odom),
        inj=jax.tree_util.tree_map(lambda x: put(x, s_spec), state.inj),
        confidence=put(state.confidence, s_spec),
        was_lost=put(state.was_lost, s_spec),
        cluster_threshold=put(state.cluster_threshold, s_spec),
        confident_threshold=put(state.confident_threshold, s_spec),
        best_pose=put(state.best_pose, s_spec),
        key=put(state.key, s_spec),
    )


# ---------------------------------------------------------------------------
# Particle-sharded SLAM (VERDICT r4 #5: the [P, H, W] map stack is the
# memory-cubic axis — sharding the SLAM particle axis distributes it)
# ---------------------------------------------------------------------------
def slam_step_sharded(state, encoder_left, encoder_right, ranges, angles,
                      mask, cfg, axis_name: str = "particle"):
    """One RBPF SLAM tick with the particle axis (poses AND per-particle
    maps) sharded on `axis_name`.

    Call inside shard_map with state.poses/logodds/weights/scores sharded
    on P(axis_name), everything else replicated.  Design mirrors
    models/slam.slam_step:

      * proposal / likelihood-field weighting / map update are purely
        per-particle — local, zero collectives;
      * weight normalization, ESS, and the posterior-mean pose need
        global reductions — [1]-scalar pmax/psum across devices;
      * the ESS-gated systematic resample rides the existing RING
        offspring exchange (_ring_systematic_draw): each particle's
        (pose, score, flattened map) rows rotate as ONE payload block, so
        per-chip peak memory stays O(P/shards) map grids — the whole
        point of sharding SLAM;
      * the best-particle (MAP) estimate all_gathers only [shards]
        scalars + poses.

    The consensus closure correction (cfg.closure) is not supported in
    the sharded step yet — it is opt-in and measured neutral-to-harmful
    on the default maze (QUIRKS.md); raise rather than silently diverge.
    """
    from ..models import mapping, slam

    if cfg.closure:
        raise NotImplementedError(
            "closure correction is not supported in slam_step_sharded")
    p_loc = state.poses.shape[0]
    n_shards = jax.lax.axis_size(axis_name)
    p_glob = p_loc * n_shards
    k_noise, k_draw, k_next = jax.random.split(state.key, 3)
    k_noise_loc = _shard_keys(k_noise, axis_name)

    new_odom, rot1, trans, rot2 = motion.diff_drive_update(
        state.odom, encoder_left, encoder_right, cfg.motion)
    turning_in_place = trans < 1e-4
    rot2 = jnp.where(turning_in_place, rot1 + rot2, rot2)
    rot1 = jnp.where(turning_in_place, 0.0, rot1)
    mcfg = dataclasses.replace(
        cfg.motion,
        alpha_1=cfg.motion.alpha_1 * cfg.alpha_scale,
        alpha_2=cfg.motion.alpha_2 * cfg.alpha_scale,
        alpha_3=cfg.motion.alpha_3 * cfg.alpha_scale,
        alpha_4=cfg.motion.alpha_4 * cfg.alpha_scale)
    ranges = jnp.asarray(ranges, jnp.float32)
    angles = jnp.asarray(angles, jnp.float32)
    mask = jnp.asarray(mask, jnp.float32)

    n_rot1, n_trans, n_rot2 = motion.sample_motion_noise(
        k_noise_loc, rot1, trans, rot2, mcfg, (p_loc,))
    poses = motion.propagate_particles(state.poses, n_rot1, n_trans,
                                       n_rot2)
    poses = poses.at[:, 2].set(normalize_angle(poses[:, 2]))

    win, offsets = slam.field_windows(state.logodds, poses, cfg)
    field = slam.hit_field(win, cfg)
    loglik = slam.scan_log_likelihood(field, poses, ranges, angles, mask,
                                      cfg, offsets)
    logw = jnp.log(state.weights) + loglik
    gmax = jax.lax.pmax(jnp.max(logw), axis_name)
    w = jnp.exp(logw - gmax)
    tot = jax.lax.psum(jnp.sum(w), axis_name)
    # Global SIR evidence increment (same statistic as the single-chip
    # step): logsumexp over ALL shards' particles.
    log_evidence = state.log_evidence + gmax + jnp.log(tot)
    w = w / tot
    ess = 1.0 / jax.lax.psum(jnp.sum(w * w), axis_name)

    h_px, w_px = state.logodds.shape[-2:]

    def _resample(operand):
        ps, lo, ww, sc = operand
        u0 = jax.random.uniform(k_draw, ())     # same key -> same u0
        payload = jnp.concatenate(
            [ps, sc[:, None], lo.reshape(p_loc, h_px * w_px)], axis=1)
        drawn = _ring_systematic_draw(payload, ww, u0, axis_name)
        return (drawn[:, :3], drawn[:, 4:].reshape(p_loc, h_px, w_px),
                jnp.full((p_loc,), 1.0 / p_glob, jnp.float32),
                drawn[:, 3])

    poses, logodds, w, scores = jax.lax.cond(
        ess < cfg.ess_threshold * p_glob,
        _resample, lambda op: op, (poses, state.logodds, w, w))

    mx = jax.lax.psum(jnp.sum(w * poses[:, 0]), axis_name)
    my = jax.lax.psum(jnp.sum(w * poses[:, 1]), axis_name)
    mt = jnp.arctan2(
        jax.lax.psum(jnp.sum(w * jnp.sin(poses[:, 2])), axis_name),
        jax.lax.psum(jnp.sum(w * jnp.cos(poses[:, 2])), axis_name))
    mean_pose = jnp.stack([mx, my, mt])

    crit = []
    if cfg.keyframe_trans > 0.0:
        crit.append(jnp.hypot(mean_pose[0] - state.kf_pose[0],
                              mean_pose[1] - state.kf_pose[1])
                    >= cfg.keyframe_trans)
    if cfg.keyframe_rot > 0.0:
        crit.append(jnp.abs(normalize_angle(mean_pose[2]
                                            - state.kf_pose[2]))
                    >= cfg.keyframe_rot)
    moved = jnp.bool_(True)
    for i, c in enumerate(crit):
        moved = c if i == 0 else (moved | c)

    def _update_maps(lo):
        return jax.vmap(
            lambda l, p: mapping.update_map(l, p, ranges, angles, mask,
                                            cfg.mapping, cfg.sensor)
        )(lo, poses)

    if crit:
        logodds = jax.lax.cond(moved, _update_maps, lambda lo: lo, logodds)
        kf_pose = jnp.where(moved, mean_pose, state.kf_pose)
        mapped = moved
    else:
        logodds = _update_maps(logodds)
        kf_pose = mean_pose
        mapped = jnp.bool_(True)

    # Global MAP estimate: local best, then [shards]-row gather of
    # (score, pose) — scalars only, never the map stack.
    loc_best = jnp.argmax(scores)
    best_sc = jax.lax.all_gather(scores[loc_best], axis_name)   # [S]
    best_ps = jax.lax.all_gather(poses[loc_best], axis_name)    # [S, 3]
    best_pose = best_ps[jnp.argmax(best_sc)]

    info = dict(pose=mean_pose, best_pose=best_pose, ess=ess,
                resampled=ess < cfg.ess_threshold * p_glob, mapped=mapped,
                closure_delta=jnp.zeros(3, jnp.float32))
    info["log_evidence"] = log_evidence
    new_state = slam.SLAMState(
        poses=poses, logodds=logodds, weights=w, scores=scores,
        odom=new_odom, key=k_next, kf_pose=kf_pose,
        closure_cool=state.closure_cool, log_evidence=log_evidence)
    return new_state, info


def make_sharded_slam_step(mesh: Mesh, cfg, axis_name: str = "particle"):
    """jit-compiled shard_map'd SLAM step over `mesh` (particle axis —
    poses AND per-particle occupancy grids — sharded)."""
    from jax import shard_map

    from ..models import slam

    state_spec = slam.SLAMState(
        poses=P(axis_name), logodds=P(axis_name), weights=P(axis_name),
        scores=P(axis_name),
        odom=motion.OdometryState(x=P(), y=P(), theta=P(),
                                  encoder_left=P(), encoder_right=P()),
        key=P(), kf_pose=P(), closure_cool=P(), log_evidence=P())
    info_spec = dict(pose=P(), best_pose=P(), ess=P(), resampled=P(),
                     mapped=P(), closure_delta=P(), log_evidence=P())

    def body(state, enc_l, enc_r, ranges, angles, mask):
        return slam_step_sharded(state, enc_l, enc_r, ranges, angles,
                                 mask, cfg, axis_name)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, P(), P(), P(), P(), P()),
        out_specs=(state_spec, info_spec),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_slam_state(state, mesh: Mesh, axis_name: str = "particle"):
    """Place a SLAMState on the mesh (particle-axis leaves sharded)."""
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    from ..models import slam

    return slam.SLAMState(
        poses=put(state.poses, P(axis_name)),
        logodds=put(state.logodds, P(axis_name)),
        weights=put(state.weights, P(axis_name)),
        scores=put(state.scores, P(axis_name)),
        odom=jax.tree_util.tree_map(lambda x: put(x, P()), state.odom),
        key=put(state.key, P()), kf_pose=put(state.kf_pose, P()),
        closure_cool=put(state.closure_cool, P()),
        log_evidence=put(state.log_evidence, P()))
