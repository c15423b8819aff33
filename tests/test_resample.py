"""Resampling + adaptive injection tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import FilterConfig, ResampleConfig
from montecarlolocalisation.maps import from_walls
from montecarlolocalisation.models import resample

MAP = from_walls([[[0, 1, 2], [1], [0, 1]],
                  [[2, 3], [3], [0, 3]]])  # 2x3 maze
CFG = FilterConfig(num_particles=512)
FALSE = jnp.bool_(False)
TRUE = jnp.bool_(True)


def _mk_particles(n, key):
    return resample.sample_uniform_particles(key, MAP, n)


def test_uniform_sampler_bounds():
    parts = np.asarray(_mk_particles(4096, jax.random.PRNGKey(0)))
    # Cells span [0, 2.4] x [0, 1.6]; centers +-0.2 + 0.05 global offset.
    assert parts[:, 0].min() >= 0.4 - 0.2 + 0.05 - 1e-5
    assert parts[:, 0].max() <= 2.0 + 0.2 + 0.05 + 1e-5
    assert parts[:, 1].max() <= 1.2 + 0.2 + 0.05 + 1e-5
    assert (parts[:, 2] >= -np.pi).all() and (parts[:, 2] <= np.pi).all()
    # All cells hit.
    rows = np.round((parts[:, 1] - 0.05 - 0.4) / 0.8).astype(int)
    cols = np.round((parts[:, 0] - 0.05 - 0.4) / 0.8).astype(int)
    assert set(zip(rows, cols)) == {(r, c) for r in range(2) for c in range(3)}


def test_packed_sampler_same_distribution():
    """The 2-word bit-packed fresh sampler must match the reference
    sampler's support and (coarsely) its distribution: same bounds, all
    cells hit ~uniformly, yaw uniform over [-pi, pi)."""
    from montecarlolocalisation.config import InitConfig

    n = 8192
    parts = np.asarray(resample.sample_uniform_particles_packed(
        jax.random.PRNGKey(0), MAP, n, InitConfig()))
    assert parts[:, 0].min() >= 0.4 - 0.2 + 0.05 - 1e-5
    assert parts[:, 0].max() <= 2.0 + 0.2 + 0.05 + 1e-5
    assert parts[:, 1].max() <= 1.2 + 0.2 + 0.05 + 1e-5
    assert (parts[:, 2] >= -np.pi).all() and (parts[:, 2] < np.pi).all()
    rows = np.round((parts[:, 1] - 0.05 - 0.4) / 0.8).astype(int)
    cols = np.round((parts[:, 0] - 0.05 - 0.4) / 0.8).astype(int)
    counts = np.bincount(rows * 3 + cols, minlength=6)
    np.testing.assert_allclose(counts / n, 1.0 / 6, atol=0.02)
    # Offsets and yaw roughly uniform (mean ~center, spread ~range/sqrt12).
    offx = parts[:, 0] - 0.05 - (cols * 0.8 + 0.4)
    assert abs(offx.mean()) < 0.01 and abs(offx.std() - 0.4 / 12**0.5) < 0.01
    assert abs(parts[:, 2].mean()) < 0.1
    assert abs(parts[:, 2].std() - 2 * np.pi / 12**0.5) < 0.1


def test_resample_concentrates_on_high_weight():
    key = jax.random.PRNGKey(1)
    n = CFG.num_particles
    parts = _mk_particles(n, key)
    # All weight on particle 7; total = n so w_avg = 1 keeps w_fast/w_slow
    # at 1 and p_inject at 0.
    weights = jnp.zeros((n,)).at[7].set(float(n))
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    new_p, new_w, inj2, info = resample.resample(
        jax.random.PRNGKey(2), parts, weights, inj, FALSE, MAP, CFG)
    # p_inject <= 0 (w_fast tracks w_avg fast) -> no injection; all draws
    # copy particle 7 + confident jitter (+-0.01, theta unchanged).
    assert int(info["n_injected"]) == 0
    np.testing.assert_allclose(np.asarray(new_p[:, 0]),
                               float(parts[7, 0]), atol=0.011)
    np.testing.assert_allclose(np.asarray(new_p[:, 2]),
                               float(resample.normalize_angle(parts[7, 2])),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(new_w), 1.0 / n)


def test_injection_probability_and_cap():
    key = jax.random.PRNGKey(3)
    n = CFG.num_particles
    parts = _mk_particles(n, key)
    weights = jnp.full((n,), 0.001)
    # w_slow high, current w_avg tiny -> w_fast collapses -> heavy injection.
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    _, _, _, info_lost = resample.resample(
        jax.random.PRNGKey(4), parts, weights, inj, TRUE, MAP, CFG)
    # Lost regime: cap 200.
    assert 0 < int(info_lost["n_injected"]) <= 200
    _, _, _, info_conf = resample.resample(
        jax.random.PRNGKey(4), parts, weights, inj, FALSE, MAP, CFG)
    # Confident regime: cap 50, alpha_fast=2 -> w_fast overshoots below,
    # p_inject still > 0.
    assert int(info_conf["n_injected"]) <= 50


def test_dual_timescale_update():
    n = 16
    parts = _mk_particles(n, jax.random.PRNGKey(5))
    weights = jnp.full((n,), 2.0)  # w_avg = 2
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    _, _, inj2, _ = resample.resample(
        jax.random.PRNGKey(6), parts, weights, inj, TRUE, MAP, CFG)
    # lost: a_slow=0.05, a_fast=0.5
    assert float(inj2.w_slow) == pytest.approx(1.0 + 0.05 * (2 - 1), rel=1e-5)
    assert float(inj2.w_fast) == pytest.approx(1.0 + 0.5 * (2 - 1), rel=1e-5)


def test_zero_total_weight_does_not_nan():
    n = 64
    parts = _mk_particles(n, jax.random.PRNGKey(7))
    weights = jnp.zeros((n,))
    inj = resample.InjectionState.zero()
    new_p, new_w, inj2, info = resample.resample(
        jax.random.PRNGKey(8), parts, weights, inj, TRUE, MAP, CFG)
    assert np.isfinite(np.asarray(new_p)).all()
    assert np.isfinite(float(info["p_inject"]))


def test_multinomial_preserves_distribution():
    # Resampled population frequencies track the weights.
    n = 4096
    key = jax.random.PRNGKey(9)
    parts = jnp.stack([
        jnp.arange(n, dtype=jnp.float32),          # x = particle id
        jnp.zeros((n,)), jnp.zeros((n,))], axis=-1)
    # Scale so total = n (w_avg = 1 -> no injection).
    scale = float(n) / 10.0
    weights = jnp.where(jnp.arange(n) < 4, scale * jnp.array(
        [1.0, 2.0, 3.0, 4.0])[jnp.clip(jnp.arange(n), 0, 3)], 0.0)
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    cfg = FilterConfig(num_particles=n)
    new_p, _, _, _ = resample.resample(
        key, parts, weights, inj, FALSE, MAP, cfg)
    ids = np.round(np.asarray(new_p[:, 0])).astype(int)
    counts = np.bincount(ids, minlength=4)[:4]
    freq = counts / counts.sum()
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.03)


def test_sorted_multinomial_matches_searchsorted_exactly():
    """multinomial_indices_sorted must equal searchsorted(cdf, rs, 'left')
    on the SAME sorted draws — the cross-rank (merged bitonic sort) is an
    exact reformulation, not an approximation.  Zero-weight runs included
    (empty CDF intervals)."""
    rng = np.random.RandomState(0)
    for n in (64, 1000, 4096):
        w = rng.exponential(size=n).astype(np.float32)
        w[rng.randint(n, size=n // 8)] = 0.0
        cdf = jnp.cumsum(jnp.asarray(w / w.sum()))
        key = jax.random.PRNGKey(3)
        idx = np.asarray(resample.multinomial_indices_sorted(key, cdf))
        rs = np.asarray(resample.sorted_uniforms(key, n))
        want = np.clip(np.searchsorted(np.asarray(cdf), rs, side="left"),
                       0, n - 1)
        assert (np.diff(idx) >= 0).all()
        np.testing.assert_array_equal(idx, want)
    # Order statistics: rs ascending in (0, 1).
    assert (np.diff(rs) >= 0).all() and rs[0] > 0.0 and rs[-1] < 1.0


def test_sorted_multinomial_mode_preserves_distribution():
    """resample(multinomial_impl='sorted') draws the same multinomial
    multiset as the exact searchsorted path (population frequencies track
    the weights)."""
    n = 4096
    parts = jnp.stack([
        jnp.arange(n, dtype=jnp.float32),
        jnp.zeros((n,)), jnp.zeros((n,))], axis=-1)
    scale = float(n) / 10.0
    weights = jnp.where(jnp.arange(n) < 4, scale * jnp.array(
        [1.0, 2.0, 3.0, 4.0])[jnp.clip(jnp.arange(n), 0, 3)], 0.0)
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    cfg = FilterConfig(num_particles=n, resample=ResampleConfig(
        multinomial_impl="sorted"))
    new_p, _, _, _ = resample.resample(
        jax.random.PRNGKey(9), parts, weights, inj, FALSE, MAP, cfg)
    ids = np.round(np.asarray(new_p[:, 0])).astype(int)
    counts = np.bincount(ids, minlength=4)[:4]
    freq = counts / counts.sum()
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.03)


def test_systematic_mode():
    n = 4096
    cfg = FilterConfig(
        num_particles=n,
        resample=ResampleConfig(method="systematic"))
    parts = jnp.stack([
        jnp.arange(n, dtype=jnp.float32),
        jnp.zeros((n,)), jnp.zeros((n,))], axis=-1)
    # total = n so w_avg = 1 -> p_inject = 0 (no injection noise).
    weights = jnp.where(jnp.arange(n) < 2, float(n) / 2, 0.0)
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(1.0))
    new_p, _, _, _ = resample.resample(
        jax.random.PRNGKey(10), parts, weights, inj, FALSE, MAP, cfg)
    ids = np.round(np.asarray(new_p[:, 0])).astype(int)
    counts = np.bincount(ids, minlength=2)[:2]
    # Systematic: exactly proportional (n/2 each) up to 1.
    assert abs(counts[0] - n // 2) <= 1 and abs(counts[1] - n // 2) <= 1


def test_fresh_sampling_cond_is_bit_identical():
    """The p_inject == 0 cond branch skips fresh sampling bit-identically.

    Same key, same particles/weights: the only difference between the two
    injection states is whether fresh sampling runs, and with p_inject == 0
    the inject mask is provably all-false, so the outputs must match what
    an always-sampling implementation produced (drawn + jitter only).
    """
    key = jax.random.PRNGKey(11)
    n = CFG.num_particles
    parts = _mk_particles(n, jax.random.PRNGKey(12))
    weights = jax.random.uniform(jax.random.PRNGKey(13), (n,)) + 0.1

    # p_inject == 0 regime: w_fast >= w_slow.
    inj0 = resample.InjectionState(w_slow=jnp.float32(0.1),
                                   w_fast=jnp.float32(0.5))
    p0, w0, _, info0 = resample.resample(key, parts, weights, inj0, TRUE,
                                         MAP, CFG)
    assert float(info0["p_inject"]) == 0.0
    assert int(info0["n_injected"]) == 0

    # Reference recomputation WITHOUT the cond: drawn + jitter, using the
    # same key splits as resample() (k_draw, k_jx, k_jy, k_jt; default
    # method is the reference-parity multinomial CDF draw).
    k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(key, 6)
    total = jnp.sum(weights)
    cdf = jnp.cumsum(weights / total)
    r = jax.random.uniform(k_draw, (n,))
    drawn = parts[jnp.clip(jnp.searchsorted(cdf, r, side="left"), 0, n - 1)]
    rcfg = CFG.resample
    jx = jax.random.uniform(k_jx, (n,), minval=-1.0, maxval=1.0) * rcfg.lost_jitter_xy
    jy = jax.random.uniform(k_jy, (n,), minval=-1.0, maxval=1.0) * rcfg.lost_jitter_xy
    jt = jax.random.uniform(k_jt, (n,), minval=-1.0, maxval=1.0) * rcfg.lost_jitter_theta
    expect = jnp.stack(
        [drawn[:, 0] + jx, drawn[:, 1] + jy,
         resample.normalize_angle(drawn[:, 2] + jt)], axis=-1)
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(expect))

    # p_inject > 0 regime still injects fresh particles (cond true branch).
    injL = resample.InjectionState(w_slow=jnp.float32(0.5),
                                   w_fast=jnp.float32(0.1))
    _, _, _, infoL = resample.resample(key, parts, weights, injL, TRUE,
                                       MAP, CFG)
    assert float(infoL["p_inject"]) > 0.0
    assert int(infoL["n_injected"]) > 0


def test_cap_binding_exact_reproduces_reference_slot_coupling():
    """When the injection cap BINDS, the `exact` impl must reproduce the
    reference's draw<->injection coupling (monte_carlo.cpp:513-528): ONE
    uniform r per slot decides inject-vs-copy, so a Bernoulli-success slot
    that arrives AFTER the cap copies via lower_bound(cdf, r) with that
    same r < p_inject — i.e. it keeps a LOW-CDF survivor.  Reconstructed
    slot-by-slot from the resample key's own r vector."""
    n = 512
    cap = 16
    rcfg = ResampleConfig(method="multinomial", multinomial_impl="exact",
                          conf_max_injection=cap,
                          conf_alpha_slow=1e-9, conf_alpha_fast=1e-9,
                          conf_jitter_xy=0.0, conf_jitter_theta=0.0)
    cfg = dataclasses.replace(CFG, resample=rcfg)
    # Identifiable survivors: x = 10 + index (fresh samples land in
    # [0.25, 2.25], so x >= 10 marks a copied particle).
    particles = jnp.stack([10.0 + jnp.arange(n, dtype=jnp.float32),
                           jnp.zeros(n), jnp.zeros(n)], axis=-1)
    w = (jnp.arange(n, dtype=jnp.float32) + 1.0) ** 2   # skewed weights
    cdf = np.cumsum(np.asarray(w) / float(np.sum(w)))
    # Tiny alphas freeze the dual-timescale state: p_inject ~ 1 - 0.5 = 0.5.
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(0.5))
    key = jax.random.PRNGKey(7)
    new_p, _, _, info = resample.resample(key, particles, w, inj, FALSE,
                                          MAP, cfg)
    p_inject = float(info["p_inject"])
    assert abs(p_inject - 0.5) < 1e-3
    # Reconstruct the slot decisions from the SAME r vector resample drew
    # (k_draw is the first of the 6-way key split, resample.py:354).
    r = np.asarray(jax.random.uniform(jax.random.split(key, 6)[0], (n,)))
    bern = r < p_inject
    inject = bern & (np.cumsum(bern) <= cap)
    capped = bern & ~inject
    assert int(inject.sum()) == cap == int(info["n_injected"])
    assert int(capped.sum()) > 100            # the cap binds, hard
    got_x = np.asarray(new_p[:, 0])
    idx = np.clip(np.searchsorted(cdf, r, side="left"), 0, n - 1)
    # Non-injected slots (incl. every capped one) copy particle
    # lower_bound(cdf, r) exactly; injected slots hold fresh samples.
    np.testing.assert_allclose(got_x[~inject], 10.0 + idx[~inject],
                               rtol=0, atol=1e-5)
    assert (got_x[inject] < 5.0).all()
    # The coupling signature: every capped slot's survivor sits in the
    # low-CDF region (cumulative mass below it < p_inject).
    below = np.where(idx[capped] > 0, cdf[idx[capped] - 1], 0.0)
    assert (below < p_inject).all()


def test_cap_binding_sorted_keeps_marginal_frequencies():
    """Same cap-binding setup on the `sorted` impl: injection uses an
    INDEPENDENT uniform (QUIRKS fast-path table, last row), so which
    survivors keep slots is decoupled — capped slots are NOT restricted
    to the low-CDF region, and across keys the surviving draws match the
    unconditioned multinomial marginals (the weights themselves)."""
    n = 512
    cap = 16
    rcfg = ResampleConfig(method="multinomial", multinomial_impl="sorted",
                          conf_max_injection=cap,
                          conf_alpha_slow=1e-9, conf_alpha_fast=1e-9,
                          conf_jitter_xy=0.0, conf_jitter_theta=0.0)
    cfg = dataclasses.replace(CFG, resample=rcfg)
    particles = jnp.stack([10.0 + jnp.arange(n, dtype=jnp.float32),
                           jnp.zeros(n), jnp.zeros(n)], axis=-1)
    w = (jnp.arange(n, dtype=jnp.float32) + 1.0) ** 2
    probs = np.asarray(w) / float(np.sum(w))
    inj = resample.InjectionState(w_slow=jnp.float32(1.0),
                                  w_fast=jnp.float32(0.5))
    step = jax.jit(lambda k: resample.resample(k, particles, w, inj,
                                               FALSE, MAP, cfg))
    counts = np.zeros(n)
    kept_total = 0
    high_cdf_survivors = 0
    keys = 64
    for s in range(keys):
        new_p, _, _, info = step(jax.random.PRNGKey(100 + s))
        assert int(info["n_injected"]) == cap     # cap still binds
        got_x = np.asarray(new_p[:, 0])
        kept = got_x >= 5.0                       # survivor slots
        src = np.rint(got_x[kept] - 10.0).astype(int)
        counts += np.bincount(src, minlength=n)
        kept_total += int(kept.sum())
        # Decoupling: the surviving multiset includes HIGH-r draws in
        # slots the exact path would have filled from the low-CDF region.
        high_cdf_survivors += int((src >= n - 8).sum())
    assert high_cdf_survivors > 0
    # Marginals: E[count_i] = probs_i among survivors (the sorted draw is
    # the full unconditioned multinomial; injection only masks slots).
    emp = counts / kept_total
    # Aggregate into 8 CDF bins to keep the tolerance meaningful.
    bins = np.add.reduceat(emp, np.arange(0, n, n // 8))
    want = np.add.reduceat(probs, np.arange(0, n, n // 8))
    np.testing.assert_allclose(bins, want, atol=0.02)


# ---------------------------------------------------------------------------
# Systematic expansion (scatter-max + cummax + gather, plain XLA) vs a NumPy
# reference of the same closed form.
# ---------------------------------------------------------------------------
def _skewed_weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        w = np.ones(n)
    elif kind == "one_hot":
        w = np.zeros(n)
        w[rng.integers(n)] = 1.0
    elif kind == "all_zero":
        w = np.zeros(n)
    else:                               # heavy-tailed (Pareto)
        w = rng.pareto(1.2, n)
    return jnp.asarray(w, jnp.float32)


def _normalized_cdf(w):
    # resample.resample's rule: all-zero weights fall back to uniform.
    n = w.shape[-1]
    total = jnp.sum(w, axis=-1, keepdims=True)
    return jnp.cumsum(jnp.where(total > 0.0, w / total, 1.0 / n), axis=-1)


def _expand_reference(cdf, u0):
    """Sequential expansion of the offspring counts
    c_i = clip(floor(N cdf_i - u0) + 1, 0, N), prefix-maxed: draw k goes to
    the first particle whose count exceeds k."""
    cdf = np.asarray(cdf, np.float32)
    n = cdf.shape[0]
    c = np.clip(np.floor(np.float32(n) * cdf - np.float32(u0))
                .astype(np.int64) + 1, 0, n)
    c = np.maximum.accumulate(c)
    idx = np.empty(n, np.int64)
    i = 0
    for k in range(n):
        while c[i] <= k:
            i += 1
        idx[k] = i
    return idx


@pytest.mark.parametrize("batched", [False, True], ids=["single", "vmap"])
@pytest.mark.parametrize("kind", ["uniform", "one_hot", "all_zero",
                                  "heavy_tailed"])
def test_systematic_expansion_matches_numpy(kind, batched):
    n, n_ep = 512, 3
    keys = jax.random.split(jax.random.PRNGKey(4), n_ep)
    parts = jax.random.normal(keys[0], (n_ep, n, 3))
    u0 = jax.random.uniform(keys[1], (n_ep,))
    cdf = _normalized_cdf(jnp.stack([_skewed_weights(kind, n, s)
                                     for s in range(n_ep)]))
    draw = lambda p, c, u: p[resample.systematic_indices(c, u)]
    if batched:
        got = np.asarray(jax.vmap(draw)(parts, cdf, u0))
    else:
        got = np.stack([np.asarray(draw(parts[e], cdf[e], u0[e]))
                        for e in range(n_ep)])
    for e in range(n_ep):
        idx = _expand_reference(cdf[e], u0[e])
        np.testing.assert_array_equal(got[e], np.asarray(parts[e])[idx])
        if kind == "one_hot":
            assert len(set(idx.tolist())) == 1
        if kind in ("uniform", "all_zero"):
            np.testing.assert_array_equal(idx, np.arange(n))


def test_offspring_counts_monotone_and_total():
    n = 4096
    w = jax.random.uniform(jax.random.PRNGKey(8), (n,)) ** 6
    cdf = _normalized_cdf(w)
    for u0 in (0.0, 0.37, 0.999):
        c = np.asarray(resample.offspring_counts(cdf, jnp.float32(u0)))
        assert np.all(np.diff(c) >= 0)
        assert 0 <= c[0] and c[-1] == n
