"""Fused beam-weight kernel for the GPU: Pallas through Triton.

The hot op of the filter (SURVEY.md §7 stage 7): per particle x beam,
cast the ray against the occupancy raster with the closed-form slab
caster (ops/analytic) and accumulate the reference likelihood
(monte_carlo.cpp:623-682) — one kernel, one read of the particle block,
one write of the weight block.

What the kernel does that the dense XLA path (sensor._beam_weights_dense)
does not: the per-particle trig and the caster's candidate-word selection
(ops/analytic `prepare`) run ONCE per particle, outside the beam loop.
The dense path evaluates both for every (particle, beam) pair, because
XLA does not hoist them across the [N, 1] -> [N, B] broadcast.  Only the
analytic caster gains from this; the fixed-step march stays on the dense
path (PERF.md, PR 1 findings).

Beam combination: "sum" (reference semantics — validity + summed probs
resolved in-kernel) or "log" (product likelihood — the kernel emits raw
per-particle log-sums; the per-episode max-log shift, temperature, and
validity gate run in XLA afterwards, sensor.finish_log_weights).

Layout: particles as [E, N] coordinate planes (E episodes, 1 for a single
filter), grid (episode, particle block), 1-D blocks of BLOCK particles.
The beam table and each episode's scan are ordinary block inputs, read
one scalar per beam inside the loop.

Matches models/sensor.beam_weights up to two deliberate reassociations:
ray directions come from the angle-addition identity, and beams
accumulate sequentially.  Either can move a hit across a pixel-boundary
tie (ops/analytic module docstring).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SensorModelConfig
from ..maps.grid import MazeMap
from .bitlookup import MapBitTables, is_concrete_map

# Particles per block.  At 1M x 34 on an H100, 128 ran the stage in
# 0.88 ms, 256 in 0.97, 512 in 1.16, 1024 in 1.46 (PERF.md, PR 1).
BLOCK = 128


def supports(m: MazeMap, particles, cfg: SensorModelConfig,
             valid_offset: float) -> bool:
    """Whether the kernel computes exactly what sensor.beam_weights asks:
    the analytic caster on a gridline raster, validity offset of one
    pixel, unquantized directions, a sum or log beam combination."""
    if (cfg.ray_mode != "analytic" or particles.ndim != 2
            or abs(valid_offset - m.resolution) > 1e-9
            or not is_concrete_map(m) or cfg.quantize_ray_deg
            or cfg.beam_combine not in ("sum", "log")):
        return False
    from .analytic import AnalyticCasterCache

    return AnalyticCasterCache.get(m) is not None


def _weights_kernel(cos_ref, sin_ref, obs_ref, rand_ref, msk_ref, x_ref,
                    y_ref, th_ref, out_ref, *, cfg: SensorModelConfig,
                    num_beams: int, geom: tuple, dil_lookup, cast_fn):
    (res, origin_x, origin_y, extent_x, extent_y) = geom
    x = x_ref[...]
    y = y_ref[...]
    th = th_ref[...]

    # Per-particle trig hoisted out of the beam loop: ray directions come
    # from the angle-addition identity (4 multiplies per beam instead of
    # two transcendentals).
    cth = jnp.cos(th)
    sth = jnp.sin(th)
    ox = x + cfg.laser_offset * cth
    oy = y + cfg.laser_offset * sth
    sigma = cfg.sigma
    denom = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    log_mode = cfg.beam_combine == "log"

    # Direction-independent cast state (grid coords, preselected candidate
    # line words, origin-pixel hits), once per particle.
    cast_ctx = cast_fn.prepare(ox, oy, cfg.max_range)

    def beam_body(b, prob):
        cb = cos_ref[b]
        sb = sin_ref[b]
        dist = cast_fn.cast_prepared(cast_ctx, cth * cb - sth * sb,
                                     sth * cb + cth * sb)
        diff = jnp.abs(obs_ref[b] - dist)
        gauss = jnp.where(
            diff <= cfg.gauss_max_diff,
            jnp.exp(-(diff * diff) / (2.0 * sigma * sigma)) * denom, 0.0)
        per_beam = cfg.w_hit * gauss + rand_ref[b]
        if log_mode:
            # Floored log, mask scaling the LOG term (sensor.py dense path).
            per_beam = jnp.log(jnp.maximum(per_beam, 1e-6))
        return prob + msk_ref[b] * per_beam

    prob = jax.lax.fori_loop(0, num_beams, beam_body, jnp.zeros_like(x))
    if log_mode:
        # Raw log-sums: temperature, max shift, and validity are applied
        # by the caller (they need the whole episode).
        out_ref[...] = prob
        return
    # isValidPos: inside the world, and not within one pixel of a wall
    # (the dilated raster; C++ static_cast<int> truncation).
    pmx = ((x - origin_x) * (1.0 / res)).astype(jnp.int32)
    pmy = ((y - origin_y) * (1.0 / res)).astype(jnp.int32)
    inside = ((x >= origin_x) & (x < extent_x)
              & (y >= origin_y) & (y < extent_y))
    out_ref[...] = jnp.where(inside & ~dil_lookup(pmy, pmx), prob, 0.0)


def beam_weights_kernel(m: MazeMap, particles, angles, ranges, mask,
                        cfg: SensorModelConfig, interpret: bool = False):
    """Episode-batched launch: particles [E, N, 3] -> weights [E, N].

    One shared beam table `angles` [B]; per-episode observations
    `ranges`/`mask` [E, B].  In beam_combine="log" mode the result is the
    RAW per-particle log-sum (see sensor.finish_log_weights).  Pads N to
    a BLOCK multiple and B to a power of two.  `interpret=True` runs the
    kernel in the Pallas interpreter (tests).
    """
    if not supports(m, particles[0], cfg, float(m.resolution)):
        raise ValueError(
            "the fused kernel needs ray_mode='analytic' on a concrete "
            "gridline raster, unquantized directions and a sum or log "
            f"combination (got ray_mode={cfg.ray_mode!r}, "
            f"beam_combine={cfg.beam_combine!r})")
    from .analytic import AnalyticCasterCache

    cast_fn = AnalyticCasterCache.get(m)
    _, dil_lookup = MapBitTables.get(m)
    geom = (float(m.resolution), float(m.origin_x), float(m.origin_y),
            float(m.extent_x), float(m.extent_y))
    n_ep, n = particles.shape[0], particles.shape[1]
    nb = int(angles.shape[0])
    n_pad = -(-n // BLOCK) * BLOCK
    b_pad = max(1, 1 << (nb - 1).bit_length())
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    angles = jnp.asarray(angles, jnp.float32)
    pad_b = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, b_pad - nb)])
    cos_b = pad_b(jnp.cos(sign * angles))
    sin_b = pad_b(jnp.sin(sign * angles))
    ranges = jnp.asarray(ranges, jnp.float32)
    # The random-hit term depends on the observation alone: one value per
    # (episode, beam), computed here rather than per particle.
    rand = pad_b(cfg.w_rand * (jnp.abs(ranges - cfg.max_range)
                               < cfg.rand_window).astype(jnp.float32))
    ranges = pad_b(ranges)
    mask = pad_b(jnp.asarray(mask, jnp.float32))
    coord = lambda j: jnp.pad(particles[:, :, j], ((0, 0), (0, n_pad - n)))
    x, y, th = coord(0), coord(1), coord(2)

    # Inside shard_map (check_vma=True) the out aval must carry the same
    # varying-mesh-axes set as the particle blocks, and every operand
    # must share that set: lift the replicated scan tables up to it.
    # Outside shard_map vma is the empty frozenset and this is a no-op.
    vma = getattr(jax.typeof(x), "vma", None)
    if vma:
        def _lift(o):
            missing = tuple(vma - jax.typeof(o).vma)
            return (jax.lax.pcast(o, missing, to="varying") if missing
                    else o)
        y, th, cos_b, sin_b, ranges, rand, mask = map(
            _lift, (y, th, cos_b, sin_b, ranges, rand, mask))

    kernel = functools.partial(
        _weights_kernel, cfg=cfg, num_beams=nb, geom=geom,
        dil_lookup=dil_lookup, cast_fn=cast_fn)
    row = pl.BlockSpec((None, BLOCK), lambda e, i: (e, i))
    beam = pl.BlockSpec((b_pad,), lambda e, i: (0,))
    ep_beam = pl.BlockSpec((None, b_pad), lambda e, i: (e, 0))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_ep, n_pad), jnp.float32, vma=vma),
        grid=(n_ep, n_pad // BLOCK),
        in_specs=[beam, beam, ep_beam, ep_beam, ep_beam, row, row, row],
        out_specs=row,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="beam_weights",
    )(cos_b, sin_b, ranges, rand, mask, x, y, th)
    return out[:, :n]
