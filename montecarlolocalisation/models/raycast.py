"""Ray casting against the occupancy raster (jit-safe, fully vectorized).

Two modes:
  * "fixed"  — the reference semantics: march r = 0, 0.1, ... < max_range and
               return the first r whose sample pixel is occupied, else
               max_range (monte_carlo.cpp:350-390 raycast).  Out-of-map
               samples terminate the march with max_range.
  * "dda"    — exact amanatides-woo grid traversal with a static iteration
               bound; returns the exact distance to the entered wall cell.

Both are pure functions of broadcastable arrays: origins, angles -> distances,
so the same code serves the per-particle sensor model (vmapped over
particles x beams) and the scan simulator.  The reference's ~1-degree ray
direction quantization (monte_carlo.cpp:355-363) is available behind
`quantize_ray_deg`.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, is_occupied, world_to_map


def _maybe_quantize(angle, cfg: SensorModelConfig):
    if not cfg.quantize_ray_deg:
        return angle
    deg = angle * (180.0 / jnp.pi)
    return jnp.round(deg) * (jnp.pi / 180.0)


def _lookup_mode(cfg: SensorModelConfig, m=None) -> str:
    mode = cfg.lookup_mode
    if mode in ("auto", "pallas"):
        # "pallas" names the fused beam-weight kernel, which has its own
        # raster probes; per-lookup callers take plain gathers.
        return "gather"
    if mode == "bits" and m is not None:
        from ..ops.bitlookup import is_concrete_map

        if not is_concrete_map(m):
            return "onehot"  # traced map (vmap over maps): no host bits
    return mode


def _occupied_fn(cfg: SensorModelConfig, m=None):
    mode = _lookup_mode(cfg, m)
    if mode == "bits":
        from ..ops.bitlookup import MapBitTables

        occ_lookup, _ = MapBitTables.get(m)

        def occupied_bits(m_, wx, wy):
            mx = ((wx - m_.origin_x) / m_.resolution).astype(jnp.int32)
            my = ((wy - m_.origin_y) / m_.resolution).astype(jnp.int32)
            return occ_lookup(my, mx)

        return occupied_bits
    if mode == "onehot":
        from ..ops.lookup import is_occupied_onehot

        return is_occupied_onehot
    return is_occupied


def raycast_fixed(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Fixed-step ray march (reference mode).

    ox, oy, angle: broadcastable arrays. Returns hit distance, same shape.
    """
    angle = _maybe_quantize(angle, cfg)
    occupied = _occupied_fn(cfg, m)
    dx = jnp.cos(angle)
    dy = jnp.sin(angle)

    # Loop over the (static, ~10) march steps with a running masked min
    # instead of materializing a [..., S] tensor: at 1M particles x B beams
    # that intermediate would be HBM-hostile.  Steps increase monotonically,
    # so min(masked r) IS the first hit.  The reference breaks the march at
    # the first out-of-map sample (worldToMap failure, monte_carlo.cpp:374)
    # — the carried `alive` mask reproduces that (matters for out-of-map
    # origins pointing inward).
    def body(s, carry):
        dist, alive = carry
        r = cfg.ray_step * s
        px = ox + r * dx
        py = oy + r * dy
        _, _, inb = world_to_map(m, px, py)  # trunc semantics, as worldToMap
        occ = occupied(m, px, py) & alive
        dist = jnp.minimum(dist, jnp.where(occ, r, cfg.max_range))
        return dist, alive & inb

    dist0 = jnp.full(ox.shape, cfg.max_range, dtype=jnp.float32)
    alive0 = jnp.ones(ox.shape, dtype=bool)
    dist, _ = jax.lax.fori_loop(0, cfg.num_ray_steps, body, (dist0, alive0),
                                unroll=True)
    return dist.astype(jnp.float32)


def _dda_iters(m: MazeMap, cfg: SensorModelConfig) -> int:
    """Static bound: cells crossed by a ray of length max_range."""
    return int(math.ceil(cfg.max_range / m.resolution)) * 2 + 2


def raycast_dda(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Exact grid traversal; returns geometric distance to the wall face.

    Bounded-iteration Amanatides-Woo DDA: every lane runs the same static
    number of iterations with a done-mask (no divergence).
    """
    angle = _maybe_quantize(angle, cfg)
    res = jnp.float32(m.resolution)
    eps = jnp.float32(1e-9)
    dx = jnp.cos(angle)
    dy = jnp.sin(angle)
    # Work in grid units (origin at map origin).
    gx = (ox - m.origin_x) / res
    gy = (oy - m.origin_y) / res
    ix = jnp.floor(gx).astype(jnp.int32)
    iy = jnp.floor(gy).astype(jnp.int32)
    step_x = jnp.where(dx >= 0, 1, -1).astype(jnp.int32)
    step_y = jnp.where(dy >= 0, 1, -1).astype(jnp.int32)
    inv_dx = 1.0 / jnp.where(jnp.abs(dx) < eps, eps, dx)
    inv_dy = 1.0 / jnp.abs(jnp.where(jnp.abs(dy) < eps, eps, dy))
    inv_dx = jnp.abs(inv_dx)
    # Distance (world meters) to the first x/y grid-line crossing.
    frac_x = jnp.where(dx >= 0, 1.0 - (gx - ix), gx - ix)
    frac_y = jnp.where(dy >= 0, 1.0 - (gy - iy), gy - iy)
    t_max_x = frac_x * res * inv_dx
    t_max_y = frac_y * res * inv_dy
    t_delta_x = res * inv_dx
    t_delta_y = res * inv_dy

    def in_bounds(ix, iy):
        return (ix >= 0) & (iy >= 0) & (ix < m.width) & (iy < m.height)

    mode = _lookup_mode(cfg, m)
    if mode == "bits":
        # Gather-free pixel probe: packed select chains (ops/bitlookup).
        from ..ops.bitlookup import MapBitTables

        occ_bits, _ = MapBitTables.get(m)

        def cell_occ(ix, iy):
            return occ_bits(iy, ix)
    elif mode == "onehot":
        from ..ops.lookup import onehot_lookup_2d

        def cell_occ(ix, iy):
            return onehot_lookup_2d(m.occ_f, iy, ix)
    else:
        def cell_occ(ix, iy):
            cx = jnp.clip(ix, 0, m.width - 1)
            cy = jnp.clip(iy, 0, m.height - 1)
            return m.occ[cy, cx] & in_bounds(ix, iy)

    # Start: if the origin cell itself is occupied, distance 0 (matches the
    # fixed-mode r=0 sample).
    start_hit = cell_occ(ix, iy)
    dist0 = jnp.where(start_hit, 0.0, jnp.float32(cfg.max_range))
    done0 = start_hit | ~in_bounds(ix, iy)

    def body(_, carry):
        ix, iy, t_max_x, t_max_y, dist, done = carry
        take_x = t_max_x < t_max_y
        t = jnp.where(take_x, t_max_x, t_max_y)
        nix = jnp.where(take_x, ix + step_x, ix)
        niy = jnp.where(take_x, iy, iy + step_y)
        n_t_max_x = jnp.where(take_x, t_max_x + t_delta_x, t_max_x)
        n_t_max_y = jnp.where(take_x, t_max_y, t_max_y + t_delta_y)
        hit = cell_occ(nix, niy) & ~done & (t < cfg.max_range)
        out = (~in_bounds(nix, niy) | (t >= cfg.max_range)) & ~done
        dist = jnp.where(hit, t, dist)
        done = done | hit | out
        ix = jnp.where(done, ix, nix)
        iy = jnp.where(done, iy, niy)
        t_max_x = jnp.where(done, t_max_x, n_t_max_x)
        t_max_y = jnp.where(done, t_max_y, n_t_max_y)
        return ix, iy, t_max_x, t_max_y, dist, done

    carry = (ix, iy, t_max_x.astype(jnp.float32), t_max_y.astype(jnp.float32),
             dist0.astype(jnp.float32), done0)
    carry = jax.lax.fori_loop(0, _dda_iters(m, cfg), body, carry)
    return carry[4]


def raycast_analytic(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Closed-form slab intersection (ops/analytic): exact DDA-equivalent
    distances without marching.  Falls back to DDA for rasters that are
    not gridline-structured (ragged maps) or traced maps."""
    from ..ops.analytic import AnalyticCasterCache
    from ..ops.bitlookup import is_concrete_map

    cast = AnalyticCasterCache.get(m) if is_concrete_map(m) else None
    if cast is None:
        return raycast_dda(m, ox, oy, angle, cfg)
    angle = _maybe_quantize(angle, cfg)
    return cast(ox, oy, angle, cfg.max_range)


def raycast(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    ox = jnp.asarray(ox, jnp.float32)
    oy = jnp.asarray(oy, jnp.float32)
    angle = jnp.asarray(angle, jnp.float32)
    ox, oy, angle = jnp.broadcast_arrays(ox, oy, angle)
    if cfg.ray_mode == "fixed":
        return raycast_fixed(m, ox, oy, angle, cfg)
    if cfg.ray_mode == "dda":
        return raycast_dda(m, ox, oy, angle, cfg)
    if cfg.ray_mode == "analytic":
        return raycast_analytic(m, ox, oy, angle, cfg)
    raise ValueError(f"unknown ray_mode {cfg.ray_mode!r}")
