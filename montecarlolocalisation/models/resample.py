"""Resampling with AMCL-style adaptive injection, fully vectorized.

Reference: monte_carlo.cpp:457-561 (resampleParticles) + sampleParticles
(:415-450).  The sequential reference loop becomes masked vectorized ops:

  * dual-timescale averages: w_slow += a_slow*(w_avg - w_slow),
    w_fast += a_fast*(w_avg - w_fast); p_inject = max(0, 1 - w_fast/w_slow).
  * per-draw uniform r: the SAME r decides injection (r < p_inject) and, when
    not injecting, indexes the CDF via lower_bound (searchsorted 'left').
  * the first-come injection cap (injected < max_injection) becomes
    "first k Bernoulli successes" via a cumulative-sum mask — identical
    distribution and identical count semantics.
  * jitter regimes by jitterState: lost (xy +-0.05, theta +-pi/12) vs
    confident (xy +-0.01, theta unchanged); theta re-wrapped via atan2 in
    both branches (monte_carlo.cpp:549).

`method="systematic"` swaps the multinomial draw for low-variance systematic
resampling (the production path); injection logic is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import FilterConfig, InitConfig, ResampleConfig
from ..maps.grid import MazeMap, cell_center
from ..utils.angles import normalize_angle


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InjectionState:
    """Dual-timescale weight averages (monte_carlo.cpp:125-128)."""

    w_slow: jax.Array
    w_fast: jax.Array

    @staticmethod
    def zero() -> "InjectionState":
        return InjectionState(w_slow=jnp.float32(0.0), w_fast=jnp.float32(0.0))


def _masked_cells(u, mask):
    """Map uniforms [n] in [0,1) to (row, col) drawn uniformly over the
    TRUE cells of `mask` [R, C] — inverse-CDF by comparison-count (one
    [n, R*C] reduce, no gather; cheap at maze cell counts).  An
    all-False mask falls back to all cells."""
    flat = mask.reshape(-1).astype(jnp.float32)
    flat = jnp.where(jnp.sum(flat) > 0, flat, jnp.ones_like(flat))
    cdf = jnp.cumsum(flat / jnp.sum(flat))
    idx = jnp.sum((u[:, None] >= cdf[None, :]).astype(jnp.int32), axis=1)
    idx = jnp.clip(idx, 0, flat.shape[0] - 1)
    n_cols = mask.shape[1]
    return idx // n_cols, idx % n_cols


def sample_uniform_particles(key, m: MazeMap, n: int,
                             cfg: InitConfig = InitConfig(),
                             cell_mask=None):
    """Uniform global particles (monte_carlo.cpp:415-450 sampleParticles).

    Random maze cell, uniform in-cell offset +-cell_offset, yaw in [-pi, pi],
    +global_offset on x and y.  Returns [n, 3].

    `cell_mask` [R, C] bool restricts the cell draw to True cells
    (uniform over them) — used for EXPLORED-cell injection on partial
    learned maps, where uniform-over-all-cells wastes draws on territory
    the map has no evidence to score.  None keeps the reference
    distribution exactly.
    """
    k_row, k_col, k_ox, k_oy, k_yaw = jax.random.split(key, 5)
    if cell_mask is None:
        rows = jax.random.randint(k_row, (n,), 0, m.n_rows)
        cols = jax.random.randint(k_col, (n,), 0, m.n_cols)
    else:
        rows, cols = _masked_cells(jax.random.uniform(k_row, (n,)),
                                   cell_mask)
    cx, cy = cell_center(rows.astype(jnp.float32), cols.astype(jnp.float32),
                         m.cell_meters)
    off = cfg.cell_offset
    x = cx + jax.random.uniform(k_ox, (n,), minval=-off, maxval=off)
    y = cy + jax.random.uniform(k_oy, (n,), minval=-off, maxval=off)
    yaw = jax.random.uniform(k_yaw, (n,), minval=-jnp.pi, maxval=jnp.pi)
    return jnp.stack(
        [x + cfg.global_offset, y + cfg.global_offset, yaw], axis=-1
    ).astype(jnp.float32)


def sample_uniform_particles_packed(key, m: MazeMap, n: int,
                                    cfg: InitConfig = InitConfig(),
                                    cell_mask=None):
    """Bit-packed fresh sampler: the SAME distribution as
    sample_uniform_particles from 2 RNG words/particle instead of 5.

    The five quantities need ≈56 random bits (cell row/col, two in-cell
    offsets, yaw); five threefry sweeps generate 160.  One [2, n] bits
    call packs them: row/col from 8-bit lanes (same modulo idiom
    jax.random.randint uses — bias < 2^-5 of a cell, the C++ rand()%
    sampler shares it), offsets/yaw from 16/32-bit lanes (granularity
    0.05 m / 2^16 ≈ 1.5e-6 m and 2π/2^32 — below sensor noise by 4+
    orders).  Same support and independence; a DIFFERENT stream (any
    JAX stream already differs from the C++ rand()).  Opt-in via
    InitConfig.sampler='packed' (QUIRKS fast-path table).
    """
    w = jax.random.bits(key, (2, n), jnp.uint32)
    w1, w2 = w[0], w[1]
    if cell_mask is None:
        rows = (((w1 >> 24) & 0xFF) % jnp.uint32(m.n_rows)).astype(jnp.int32)
        cols = (((w1 >> 16) & 0xFF) % jnp.uint32(m.n_cols)).astype(jnp.int32)
    else:
        # Explored-cell draw from the same 16 bits (granularity 2^-16 of
        # the cell list — exact at any realistic cell count).
        u = ((w1 >> 16) & 0xFFFF).astype(jnp.float32) / 65536.0
        rows, cols = _masked_cells(u, cell_mask)
    cx, cy = cell_center(rows.astype(jnp.float32), cols.astype(jnp.float32),
                         m.cell_meters)
    off = cfg.cell_offset
    scale16 = jnp.float32(1.0 / 65536.0)
    ox = ((w1 & 0xFFFF).astype(jnp.float32) * scale16 * 2.0 - 1.0) * off
    oy = (((w2 >> 16) & 0xFFFF).astype(jnp.float32) * scale16 * 2.0
          - 1.0) * off
    yaw = ((w2 & 0xFFFF).astype(jnp.float32) * scale16 * 2.0
           - 1.0) * jnp.float32(jnp.pi)
    return jnp.stack(
        [cx + ox + cfg.global_offset, cy + oy + cfg.global_offset, yaw],
        axis=-1).astype(jnp.float32)


def offspring_counts(cdf, u0):
    """Cumulative offspring counts c_i = #{k : (k+u0)/N <= cdf_i}.

    The cummax guards against a parallel-scan cumsum producing a 1-ulp
    NON-monotone cdf: inverted count pairs would make two sources claim
    one output slot.
    """
    n = cdf.shape[0]
    c = jnp.clip(jnp.floor(n * cdf - u0).astype(jnp.int32) + 1, 0, n)
    return jax.lax.cummax(c)


def systematic_indices(cdf, u0):
    """Low-variance resampling WITHOUT searchsorted.

    For stratified positions u_k = (k + u0)/N, the lower_bound index array
    has closed form via per-particle offspring counts:
        c_i = #{k : u_k <= cdf_i} = clip(floor(N*cdf_i - u0) + 1, 0, N)
    Draw k belongs to the particle whose count interval covers k; the index
    array is built by scatter-max of particle ids at their interval starts
    followed by a prefix max: a few elementwise passes, no binary search.
    Output is IDENTICAL to searchsorted(cdf, u, side='left').
    """
    n = cdf.shape[0]
    c = offspring_counts(cdf, u0)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), c[:-1]])
    has_offspring = c > starts
    ids = jnp.arange(n, dtype=jnp.int32)
    scatter_pos = jnp.where(has_offspring, starts, n)  # n -> dropped
    out = jnp.zeros((n,), jnp.int32).at[scatter_pos].max(
        ids, mode="drop")
    return jax.lax.cummax(out)


def sorted_uniforms(key, n: int):
    """n ascending U(0,1) order statistics WITHOUT a sort.

    Exponential-spacings construction (Devroye 1986, ch. V): normalized
    partial sums of n+1 iid Exp(1) variables are jointly distributed as
    the order statistics of n iid uniforms — one RNG sweep + one cumsum,
    no O(n log^2 n) sort network.
    """
    u = jax.random.uniform(key, (n + 1,), minval=jnp.float32(1e-37),
                           maxval=1.0)
    s = jnp.cumsum(-jnp.log(u))
    return s[:-1] / s[-1]


def crossrank_counts(rs, cdf):
    """#{cdf_i < r} for each r in ascending `rs` — one merged lax.sort.

    The gather-free lower_bound: tag draws 0 / CDF entries 1, sort by
    (value, tag) so a draw ties BEFORE the equal CDF entry (side='left'
    semantics), then the inclusive cumsum of tags AT a draw's position is
    exactly #{cdf_i < r}; a stable sort on the tag compacts the draw
    positions back out in order.  Sort networks are vector
    compare-exchanges — no binary-search gather chains.  Returns int32
    [len(rs)], ascending.
    """
    n_r = rs.shape[0]
    v = jnp.concatenate([rs, cdf])
    tag = jnp.concatenate([jnp.zeros((n_r,), jnp.int32),
                           jnp.ones((cdf.shape[0],), jnp.int32)])
    _, st = jax.lax.sort((v, tag), num_keys=2)
    cum = jnp.cumsum(st)
    _, idx = jax.lax.sort((st, cum), num_keys=1, is_stable=True)
    return idx[:n_r].astype(jnp.int32)


def multinomial_indices_sorted(key, cdf):
    """Monotone multinomial draw: sort(searchsorted(cdf, U^N, 'left')).

    A gather-free form of the reference's per-draw CDF inversion
    (monte_carlo.cpp:497-555): draw the uniforms ALREADY SORTED
    (sorted_uniforms — the resampled multiset is permutation-invariant, so
    only the order statistics matter; the multiset distribution is
    IDENTICAL to iid draws), then cross-rank the two sorted sequences with
    merged sorts (crossrank_counts) instead of N binary-search gathers.

    Returns int32 [N], ascending, in [0, N-1].
    """
    n = cdf.shape[0]
    rs = sorted_uniforms(key, n)
    return jnp.clip(crossrank_counts(rs, cdf), 0, n - 1)


def resize_particles(key, particles, weights, n_new: int):
    """Systematic redraw of `n_new` particles from a weighted set.

    The elastic-serving primitive (no reference counterpart — the
    reference's N=1500 is a compile-time constant, monte_carlo.cpp:84):
    stratified positions u_k = (k + u0)/n_new against the weight CDF give
    offspring counts c_i = clip(floor(n_new*cdf_i - u0) + 1, 0, n_new) —
    the same closed-form expansion as systematic_indices, generalized to
    an output length different from the source count.  Degenerate all-zero
    weights fall back to a uniform draw.  Returns ([n_new, 3] particles,
    [n_new] uniform weights).
    """
    n = particles.shape[0]
    total = jnp.sum(weights)
    norm = jnp.where(total > 0.0, weights / total, jnp.float32(1.0 / n))
    cdf = jnp.cumsum(norm)
    u0 = jax.random.uniform(key, ())
    c = jax.lax.cummax(jnp.clip(
        jnp.floor(n_new * cdf - u0).astype(jnp.int32) + 1, 0, n_new))
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), c[:-1]])
    ids = jnp.arange(n, dtype=jnp.int32)
    scatter_pos = jnp.where(c > starts, starts, n_new)  # n_new -> dropped
    idx = jax.lax.cummax(
        jnp.zeros((n_new,), jnp.int32).at[scatter_pos].max(ids, mode="drop"))
    return (particles[idx],
            jnp.full((n_new,), 1.0 / n_new, dtype=jnp.float32))


def _regime(jitter_state, cfg: ResampleConfig):
    """Select lost/confident scalar params (monte_carlo.cpp:472-482).

    Under the opt-in ESS-gated schedule the dual-timescale averages must be
    proper convex combinations, so alphas are clamped to <= 1: the
    reference's conf_alpha_fast = 2.0 quirk (monte_carlo.cpp:481) makes
    w_fast an unstable oscillator (w_fast' = 2*w_avg - w_fast) that goes
    NEGATIVE when w_avg dips, and with gated resampling the resulting
    p_inject > 1 floods become self-sustaining (inject -> lower next-tick
    w_avg -> w_fast negative -> inject).  The default every-tick schedule
    keeps the quirk bit-exactly.
    """
    clamp = ((lambda a: min(float(a), 1.0))
             if cfg.ess_threshold is not None else float)
    sel = lambda a, b: jnp.where(jitter_state, jnp.float32(a), jnp.float32(b))
    return dict(
        max_injection=sel(cfg.lost_max_injection, cfg.conf_max_injection),
        alpha_slow=sel(clamp(cfg.lost_alpha_slow), clamp(cfg.conf_alpha_slow)),
        alpha_fast=sel(clamp(cfg.lost_alpha_fast), clamp(cfg.conf_alpha_fast)),
        jitter_xy=sel(cfg.lost_jitter_xy, cfg.conf_jitter_xy),
        jitter_theta=sel(cfg.lost_jitter_theta, cfg.conf_jitter_theta),
    )


def update_injection(weights, inj: InjectionState, jitter_state,
                     cfg: FilterConfig):
    """Dual-timescale average update (monte_carlo.cpp:487-492).

    `weights` is the per-tick beam likelihood (unnormalized).  Returns
    (new InjectionState, p_inject, w_avg, total_weight).  Shared by the
    every-tick resample pass and the ESS-gated skip branch so kidnap
    detection keeps tracking the measurement likelihood either way.
    """
    p = _regime(jitter_state, cfg.resample)
    total = jnp.sum(weights)
    w_avg = total / weights.shape[0]
    w_slow = inj.w_slow + p["alpha_slow"] * (w_avg - inj.w_slow)
    w_fast = inj.w_fast + p["alpha_fast"] * (w_avg - inj.w_fast)
    # Guard the 0/0 at startup (C++ std::max(0.0, nan) -> 0.0).
    p_inject = jnp.where(
        w_slow > 0.0, jnp.maximum(0.0, 1.0 - w_fast / w_slow), 0.0)
    return InjectionState(w_slow, w_fast), p_inject, w_avg, total


def resample(
    key,
    particles,              # [N, 3]
    weights,                # [N] unnormalized (from beam_weights)
    inj: InjectionState,
    jitter_state,           # traced bool: True = lost regime
    m: MazeMap,
    cfg: FilterConfig,
    draw_weights=None,      # [N] optional CDF weights (default: `weights`);
                            # `weights` always feeds injection bookkeeping
    cell_mask=None,         # [R, C] bool: restrict fresh injection to these
                            # cells (partial-map explored-cell injection)
) -> Tuple[jax.Array, jax.Array, InjectionState, dict]:
    """One resampling pass.  Returns (particles, weights=1/N, inj, info)."""
    rcfg = cfg.resample
    n = particles.shape[0]
    p = _regime(jitter_state, rcfg)
    new_inj, p_inject, w_avg, total = update_injection(
        weights, inj, jitter_state, cfg)

    # Normalized CDF; degenerate all-zero weights fall back to uniform.
    if draw_weights is None:
        draw_weights, draw_total = weights, total
    else:
        draw_total = jnp.sum(draw_weights)
    norm_w = jnp.where(draw_total > 0.0, draw_weights / draw_total, 1.0 / n)
    cdf = jnp.cumsum(norm_w)

    k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(key, 6)
    if rcfg.method == "multinomial":
        impl = rcfg.multinomial_impl
        if impl == "sorted":
            # Sorted multinomial: same multiset distribution, no
            # searchsorted gathers; injection decoupled (QUIRKS.md).
            inject_r = jax.random.uniform(k_inj, (n,))
            drawn = particles[multinomial_indices_sorted(k_draw, cdf)]
        elif impl == "exact":
            r = jax.random.uniform(k_draw, (n,))
            inject_r = r
            # CDF draw (lower_bound == side='left'), clipped for fp
            # round-off.
            idx = jnp.clip(jnp.searchsorted(cdf, r, side="left"), 0, n - 1)
            drawn = particles[idx]
        else:
            raise ValueError(f"unknown multinomial_impl {impl!r}")
    elif rcfg.method == "systematic":
        u0 = jax.random.uniform(k_draw, ())
        inject_r = jax.random.uniform(k_inj, (n,))
        drawn = particles[systematic_indices(cdf, u0)]
    else:
        raise ValueError(f"unknown resample method {rcfg.method!r}")

    # Injection: Bernoulli successes, capped first-come (monte_carlo.cpp:518).
    bern = inject_r < p_inject
    inject = bern & (jnp.cumsum(bern) <= p["max_injection"])
    n_injected = jnp.sum(inject)
    jx = jax.random.uniform(k_jx, (n,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
    jy = jax.random.uniform(k_jy, (n,), minval=-1.0, maxval=1.0) * p["jitter_xy"]
    jt = jax.random.uniform(k_jt, (n,), minval=-1.0, maxval=1.0) * p["jitter_theta"]
    drawn = jnp.stack(
        [drawn[:, 0] + jx, drawn[:, 1] + jy,
         normalize_angle(drawn[:, 2] + jt)],
        axis=-1,
    )

    # Fresh-particle sampling only runs when it can matter: p_inject == 0
    # makes `inject` provably all-false (inject_r is uniform in [0, 1)),
    # so the cond's zero branch is bit-identical and skips the RNG
    # sweeps over N on most converged-tracking steps.  Under vmap the
    # cond lowers to a select (both branches run) — same semantics, no
    # win.  The packed sampler (2 RNG words/particle instead of 5
    # sweeps) is an explicit option (InitConfig.sampler).
    sample_fn = (sample_uniform_particles_packed
                 if cfg.init.sampler == "packed"
                 else sample_uniform_particles)
    fresh = jax.lax.cond(
        p_inject > 0.0,
        lambda: sample_fn(k_fresh, m, n, cfg.init, cell_mask),
        lambda: jnp.zeros((n, 3), jnp.float32))
    new_particles = jnp.where(inject[:, None], fresh, drawn)
    new_weights = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
    info = dict(p_inject=p_inject, n_injected=n_injected, w_avg=w_avg,
                total_weight=total)
    return new_particles, new_weights, new_inj, info


def ess_gated_resample(
    key,
    particles,              # [N, 3]
    likelihood,             # [N] per-tick beam likelihood (unnormalized)
    carried_w,              # [N] carried importance weights (prev tick)
    inj: InjectionState,
    jitter_state,
    m: MazeMap,
    cfg: FilterConfig,
    cell_mask=None,         # [R, C] bool: explored-cell injection
) -> Tuple[jax.Array, jax.Array, InjectionState, dict]:
    """ESS-gated SIR resampling (opt-in via cfg.resample.ess_threshold).

    Carried importance weights accumulate the per-tick likelihood
    (w_t ∝ w_{t-1} · p(z_t | x_t), normalized each tick); the full
    resampling pass (CDF draw + jitter + adaptive injection) runs only when
    the effective sample size ESS = 1/Σ ŵ² falls below ess_threshold · N —
    the standard production SIR schedule.  Skipped ticks return the
    particle set untouched (no sampling noise, no jitter) and, under
    lax.cond, skip the resample stage's compute entirely.  The
    reference instead resamples every tick with fresh per-tick weights
    (monte_carlo.cpp:457-561); ess_threshold=None keeps that behavior.

    Injection bookkeeping (w_slow/w_fast) updates from the PER-TICK
    likelihood average on every tick — gated or not — so kidnapped-robot
    detection (monte_carlo.cpp:487-492) is unaffected by the schedule.
    The pass also fires whenever the detector REQUESTS injection
    (p_inject > 0): random-particle injection can only happen inside a
    resampling pass, so gating it on ESS alone would batch recovery
    particles into rare bursty floods and delay kidnap recovery — measured
    to let a symmetric-maze alias capture the carried weight mass.  During
    healthy tracking p_inject is 0 and the skip rate is set by ESS alone.
    Degenerate all-zero weights normalize to uniform (ESS = N), which
    skips the draw; the next informative scan re-skews them.
    """
    n = particles.shape[0]
    tau = cfg.resample.ess_threshold
    combined = carried_w * likelihood
    total_c = jnp.sum(combined)
    norm = jnp.where(total_c > 0.0, combined / total_c,
                     jnp.float32(1.0 / n))
    ess = 1.0 / jnp.sum(norm * norm)
    # Same deterministic update the taken branch recomputes below — run
    # here only to read the injection request off this tick's likelihood.
    _, p_inject_now, _, _ = update_injection(
        likelihood, inj, jitter_state, cfg)

    def _do_resample():
        return resample(key, particles, likelihood, inj, jitter_state, m,
                        cfg, draw_weights=norm, cell_mask=cell_mask)

    def _skip():
        new_inj, p_inject, w_avg, total = update_injection(
            likelihood, inj, jitter_state, cfg)
        info = dict(p_inject=p_inject, n_injected=jnp.int32(0),
                    w_avg=w_avg, total_weight=total)
        return particles, norm, new_inj, info

    return jax.lax.cond((ess < tau * n) | (p_inject_now > 0.0),
                        _do_resample, _skip)
