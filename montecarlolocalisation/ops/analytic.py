"""Analytic slab ray casting: exact first-hit distances in closed form.

Maze rasters (rectangular maps) place wall pixels only on multiple-of-8
gridline rows/columns (publish_map_rviz.cpp drawing rules), i.e. the
obstacle set is a union of axis-aligned slabs one pixel (0.1 m) thick on a
0.8 m lattice.  A ray of length <= max_range crosses at most
ceil(max_range / 0.8) + 1 vertical and horizontal slabs, so the first hit
has a CLOSED FORM: per candidate slab, the entry/exit times and the range
of pixel rows (columns) touched inside the slab; a hit exists iff the
slab's packed bit-column has any bit in that range, and the hit time is
max(slab entry, first-set-row entry).  No marching, no gathers — ~40 VPU
ops per candidate, all fusible.

Exactness: identical to the DDA traversal (raycast_dda) up to float
rounding at pixel-boundary ties; verified against DDA on random rays in
tests/test_analytic.py.  Requires a gridline-structured raster; callers
fall back to DDA otherwise (ragged maps).

Bit tricks used (plain XLA elementwise ops, no ctz/clz primitive needed):
lowest set bit position of a uint32 via the float32 exponent of (x & -x);
highest set bit via the exponent of the value itself.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bitlookup import _is_gridline_structured, _pack_rows, _select_words

_F32_BIAS = 127


def _first_bit_pos(words, forward):
    """Directional first-set-bit of a multi-word value (word j = bits
    32j..32j+31): lowest where `forward` (elementwise bool), highest
    otherwise.  UNDEFINED (finite garbage, no NaN/inf) when the value is
    zero — callers gate on any-bit-set.

    One fused scan per word instead of computing lowest AND highest then
    selecting: the isolated-bit / raw-value choice moves to the INPUT of
    a single exponent extraction (the hot path of the analytic caster
    runs this twice per slab candidate).
    """
    def scan32(x):
        iso = x & (~x + jnp.uint32(1))
        z = jnp.where(forward, iso, x)
        zi = jax.lax.bitcast_convert_type(z, jnp.int32)
        top = zi < 0
        f = jnp.abs(zi.astype(jnp.float32))
        e = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - _F32_BIAS
        # Backward mode only: int->float rounding can overshoot the
        # exponent by one (e.g. 0x7fffffff -> 2^31); clamp, then test.
        # Forward mode is exact (power of two) and x >> e always keeps
        # the isolated bit, so the correction is a no-op there.
        e = jnp.minimum(e, 31)
        e = jnp.where((x >> jnp.clip(e, 0, 31).astype(jnp.uint32))
                      == jnp.uint32(0), e - 1, e)
        # top & backward: the raw value is INT_MIN-side; answer is 31
        # outright (the float path saw |zi|, not the unsigned value).
        # top & forward: iso == 0x80000000 -> the float path is exact.
        return jnp.where(top & ~forward, 31, e)

    pos = [scan32(w) + 32 * j for j, w in enumerate(words)]
    nz = [w != jnp.uint32(0) for w in words]
    # Priority-select the first nonzero word along the scan direction.
    # Priority chains of selects on the position words.
    fsel = pos[-1]
    for j in range(len(words) - 2, -1, -1):   # ascending priority
        fsel = jnp.where(nz[j], pos[j], fsel)
    bsel = pos[0]
    for j in range(1, len(words)):            # descending priority
        bsel = jnp.where(nz[j], pos[j], bsel)
    return jnp.where(forward, fsel, bsel)


def _range_mask(lo_bit, hi_bit, n_words):
    """n_words uint32 words with bits [lo_bit, hi_bit] set (inclusive);
    empty if lo_bit > hi_bit.  Bits clamped into [0, 32*n_words - 1]."""
    lo_bit = jnp.clip(lo_bit, 0, 32 * n_words)
    hi_bit = jnp.clip(hi_bit, -1, 32 * n_words - 1)

    def word(base):
        # bits [max(lo-base,0), min(hi-base,31)] of one 32-bit word
        a = jnp.clip(lo_bit - base, 0, 32)
        b = jnp.clip(hi_bit - base, -1, 31)
        n = b - a + 1
        full = jnp.uint32(0xFFFFFFFF)
        m = jnp.where(
            n <= 0, jnp.uint32(0),
            jnp.where(n >= 32, full,
                      ((jnp.uint32(1) << n.astype(jnp.uint32))
                       - jnp.uint32(1))
                      << a.astype(jnp.uint32)))
        return m

    return [word(32 * j) for j in range(n_words)]


def _make_pixel_scan(line_pixels: np.ndarray):
    """Band-scan strategy over raw pixel columns: [n_lines, L] bools ->
    (select, band_scan, origin_bit) closures.  Cost scales with
    ceil(L/32) words.

    select(kk) -> ws: line kk's packed words (strategy-opaque); kk ==
    n_lines selects all-zero words (the invalid-line sentinel).
    band_scan(ws, lo_r, hi_r, fwd, span) -> (any_hit, rr): whether the
    line has a set pixel in rows [lo_r, hi_r], and the first such row
    along the scan direction (garbage when none — callers gate on
    any_hit); `span` is a STATIC upper bound on hi_r - lo_r + 1
    (unused here).
    origin_bit(ws, r0) -> bool: pixel r0 of the line (False out of range).
    """
    rows = _pack_rows(line_pixels)
    n_words = len(rows[0])

    def select(kk):
        return _select_words(kk, rows)

    def band_scan(ws, lo_r, hi_r, fwd, span):
        ms = _range_mask(lo_r, hi_r, n_words)
        bs = [wj & mj for wj, mj in zip(ws, ms)]
        acc = bs[0]
        for bj in bs[1:]:
            acc = acc | bj
        any_hit = acc != 0
        rr = _first_bit_pos(bs, fwd).astype(jnp.int32)
        return any_hit, rr

    def origin_bit(ws, r0):
        m0 = _range_mask(r0, r0, n_words)
        ob = ws[0] & m0[0]
        for wj, mj in zip(ws[1:], m0[1:]):
            ob = ob | (wj & mj)
        return ob != 0

    return select, band_scan, origin_bit


def _make_window_scan(line_pixels: np.ndarray):
    """Funnel-window band scan: extract the <= 32-bit window starting at
    lo_r from the line's packed words (cross-word variable shift), mask to
    the band, and run ONE single-word directional bit scan.  ~Half the
    mask-path ops at 2 words and near-flat in map size (the per-word cost
    collapses to one 2-way select in the straddling-pair pick).

    Applies when the band span fits 32 bits — span <= ceil(smax) + 2,
    i.e. max_range <= ~3 m at 0.1 m/px; wider spans take the mask path
    (static, per cast_dir call).
    """
    rows = _pack_rows(line_pixels)
    n_words = len(rows[0])
    n_bits = int(line_pixels.shape[1])
    _, fallback_scan, _ = _make_pixel_scan(line_pixels)

    def select(kk):
        return _select_words(kk, rows)

    def band_scan(ws, lo_r, hi_r, fwd, span):
        if span > 32:
            return fallback_scan(ws, lo_r, hi_r, fwd, span)
        lo = jnp.maximum(lo_r, 0)
        hi = jnp.minimum(hi_r, n_bits - 1)
        width = jnp.clip(hi - lo + 1, 0, 32)
        sh = (lo & 31).astype(jnp.uint32)
        # Straddling word pair (a, b) for window start lo: words lo>>5 and
        # lo>>5 + 1 (b = 0 past the end).
        a = ws[0]
        b = ws[1] if n_words > 1 else jnp.zeros_like(ws[0])
        for j in range(1, n_words):
            nxt = ws[j + 1] if j + 1 < n_words else jnp.zeros_like(ws[0])
            sel = (lo >> 5) == j
            a = jnp.where(sel, ws[j], a)
            b = jnp.where(sel, nxt, b)
        # Funnel shift; the sh == 0 guard avoids the undefined b << 32.
        hi_part = jnp.where(
            sh == 0, jnp.uint32(0),
            b << ((jnp.uint32(32) - sh) & jnp.uint32(31)))
        win = (a >> sh) | hi_part
        wmask = jnp.where(
            width >= 32, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << width.astype(jnp.uint32)) - jnp.uint32(1))
        wm = win & wmask
        any_hit = wm != jnp.uint32(0)
        rr = lo + _first_bit_pos([wm], fwd).astype(jnp.int32)
        return any_hit, rr

    def origin_bit(ws, r0):
        inb = (r0 >= 0) & (r0 < n_bits)
        r0c = jnp.clip(r0, 0, n_bits - 1)
        w = ws[0]
        for j in range(1, n_words):
            w = jnp.where((r0c >> 5) == j, ws[j], w)
        bit = (w >> (r0c & 31).astype(jnp.uint32)) & jnp.uint32(1)
        return inb & (bit == jnp.uint32(1))

    return select, band_scan, origin_bit


def _make_cell_scan(line_pixels: np.ndarray, cell_px: int):
    """Cell-level band-scan strategy: two SINGLE uint32 words per line
    instead of ceil(L/32) pixel words — map-size-independent cost (maps up
    to 31x32 cells).

    A gridline's pixel column decomposes exactly into cell INTERIORS (the
    cell_px-1 pixels strictly between consecutive corners — uniform,
    because the raster rules draw whole wall segments; word A, bit c) plus
    the shared CORNER pixels at multiples of cell_px (taken straight from
    the raster, which already unions adjacent walls and crossing
    perpendicular segments; word B, bit m).  Returns None when the
    interiors are not uniform (verified, not assumed) or they don't fit
    one word.

    The returned `rr` is the first set row along the direction EXCEPT that
    an interior segment reports its first interior row (cell_px*c + 1
    forward, cell_px*c + cell_px - 1 backward) even when the queried band
    starts mid-segment; that row is then on or before the band start, so
    the caller's s_hit = max(t_in, t_row) clamps it to the slab entry —
    exactly what the true first row would give.
    """
    n_lines, length = line_pixels.shape
    n_cells = (length - 1) // cell_px
    n_corners = n_cells + 1
    if cell_px != 8 or n_cells > 32 or n_corners > 32:
        return None
    a_tab, b_tab = [], []
    for px in line_pixels:
        a = 0
        for c in range(n_cells):
            seg = px[c * cell_px + 1: (c + 1) * cell_px]
            if seg.any() != seg.all():
                return None
            if seg[0]:
                a |= 1 << c
        b = 0
        for mc in range(n_corners):
            if px[mc * cell_px]:
                b |= 1 << mc
        a_tab.append((a,))
        b_tab.append((b,))

    # np (not jnp): a jnp scalar here would be captured as a device
    # constant, which pallas_call rejects in-kernel.
    big = np.int32(1 << 24)

    def select(kk):
        return (_select_words(kk, a_tab)[0], _select_words(kk, b_tab)[0])

    def band_scan(ws, lo_r, hi_r, fwd, span):
        a, b = ws
        # Interior of cell c ([8c+1, 8c+7]) intersects [lo, hi] iff
        # floor(lo/8) <= c <= floor((hi-1)/8); corner m (row 8m) iff
        # ceil(lo/8) <= m <= floor(hi/8).  (Arithmetic >> = floor div.)
        (mask_a,) = _range_mask(lo_r >> 3, (hi_r - 1) >> 3, 1)
        (mask_b,) = _range_mask((lo_r + 7) >> 3, hi_r >> 3, 1)
        am = a & mask_a
        bm = b & mask_b
        any_a = am != jnp.uint32(0)
        any_b = bm != jnp.uint32(0)
        pa = _first_bit_pos([am], fwd).astype(jnp.int32)
        pb = _first_bit_pos([bm], fwd).astype(jnp.int32)
        ra = (pa << 3) + jnp.where(fwd, 1, cell_px - 1)
        rb = pb << 3
        # Directional merge of the two candidates, empty words pushed to
        # the losing side (gated by any_hit when both are empty).
        rr = jnp.where(
            fwd,
            jnp.minimum(jnp.where(any_a, ra, big), jnp.where(any_b, rb, big)),
            jnp.maximum(jnp.where(any_a, ra, -big), jnp.where(any_b, rb, -big)))
        return any_a | any_b, rr

    def origin_bit(ws, r0):
        a, b = ws
        in_len = (r0 >= 0) & (r0 < length)
        r0c = jnp.clip(r0, 0, length - 1)
        idx = (r0c >> 3).astype(jnp.uint32)
        on_corner = (r0c & 7) == 0
        bit_a = ((a >> idx) & jnp.uint32(1)) == 1
        bit_b = ((b >> idx) & jnp.uint32(1)) == 1
        return in_len & ((on_corner & bit_b) | (~on_corner & bit_a))

    return select, band_scan, origin_bit


def make_analytic_caster(
    occ: np.ndarray, resolution: float, origin_x: float, origin_y: float,
    cell_px: int = 8,
) -> Optional[Callable]:
    """Build `cast(ox, oy, angle, max_range) -> dist` or None if the raster
    is not gridline-structured."""
    occ = np.asarray(occ).astype(bool)
    if not _is_gridline_structured(occ, cell_px):
        return None
    h, w = occ.shape
    # Vertical gridline columns (pixel col = 8k): bits over rows.
    n_v = (w - 1) // cell_px + 1
    v_px = occ[:, ::cell_px].T                 # [n_v, h]
    # Horizontal gridline rows (pixel row = 8r): bits over cols.
    n_h = (h - 1) // cell_px + 1
    h_px = occ[::cell_px]                      # [n_h, w]

    def _axis_scan(line_pixels):
        # Default strategy: the funnel-window scan (fewest ops, near-flat
        # in map size; falls back to the mask path per-call for spans
        # > 32 bits).  The mask and cell-table strategies remain
        # selectable for benchmarking (dev knob; BENCH_DETAILS has the
        # measured A/B).
        force = os.environ.get("MCL_ANALYTIC_SCAN")
        if force == "pixel":
            return _make_pixel_scan(line_pixels)
        if force == "cells":
            cs = _make_cell_scan(line_pixels, cell_px)
            if cs is not None:
                return cs
            return _make_pixel_scan(line_pixels)
        return _make_window_scan(line_pixels)

    v_scan = _axis_scan(v_px)
    h_scan = _axis_scan(h_px)

    # np (not jnp) scalar: a jnp scalar built at caster-construction time
    # would be captured as a device constant, which pallas_call rejects
    # when the cast runs inside the beam-weight kernel.
    inf = np.float32(3e38)
    eps = 1e-9

    def _axis_prepare(gu, gv, scans, n_lines, n_cand):
        """Direction-independent per-origin state for one axis: the origin
        slab index, the PRESELECTED candidate-line words for every offset
        the direction sign can reach (k0-(n_cand-1) .. k0+(n_cand-1)), and
        the origin-pixel hit (the origin can sit inside the c == 0 slab
        only, and only that slab's occupancy matters at s = 0).

        This is the beam-loop hoist: the select chains (the word-table
        lookups) run ONCE per origin; each direction then picks a
        preselected candidate with one 2-way select per word.
        """
        select, _, origin_bit = scans
        k0 = jnp.floor(gu / cell_px).astype(jnp.int32)
        r0 = jnp.floor(gv).astype(jnp.int32)
        pre = {}
        for off in range(-(n_cand - 1), n_cand):
            k = k0 + off
            kk = jnp.where((k >= 0) & (k < n_lines), k, n_lines)
            pre[off] = select(kk)
        line_u0 = (k0 * cell_px).astype(jnp.float32)
        # Half-open slab [u, u+1): gu == line_u0 + 1 is the next cell.
        inside0 = (gu >= line_u0) & (gu < line_u0 + 1.0)
        valid0 = (k0 >= 0) & (k0 < n_lines)
        # Origin inside the slab's occupied pixel -> hit at 0 even when
        # the forward window is empty (e.g. moving out across the entry
        # face; DDA/fixed return 0 for an occupied origin cell).
        origin0 = inside0 & valid0 & origin_bit(pre[0], r0)
        return dict(k0=k0, pre=pre, inside0=inside0, origin0=origin0)

    def _axis_hits(gu, gv, du, dv, n_lines, scans, prep, smax, n_cand,
                   span):
        """First-hit s (pixel units) against slabs perpendicular to u.

        gu/gv: origin coords (u = axis normal to the lines, v = along).
        Returns s_hit (inf when none) over n_cand candidate lines (the
        origin's slab plus every line reachable within smax).  `scans` is
        the axis's (select, band_scan, origin_bit) strategy; `prep` its
        _axis_prepare output; `span` the static bound on a band's bit
        count (ceil(smax) + 2).
        """
        _, band_scan, _ = scans
        small = jnp.abs(du) < eps
        inv_du = 1.0 / jnp.where(small, eps, du)
        pos_dir = du >= 0
        sgn = jnp.where(pos_dir, 1, -1).astype(jnp.int32)
        k0 = prep["k0"]
        fwd = dv >= 0
        small_v = jnp.abs(dv) < eps
        inv_dv = 1.0 / jnp.where(small_v, eps, dv)
        best = jnp.where(prep["origin0"], 0.0, inf)
        for c in range(n_cand):
            k = k0 + sgn * c
            line_u = (k * cell_px).astype(jnp.float32)   # slab [u, u+1)
            # Entry/exit times in pixel units.
            t_near = (line_u - gu) * inv_du
            t_far = (line_u + 1.0 - gu) * inv_du
            t_in = jnp.minimum(t_near, t_far)
            t_out = jnp.maximum(t_near, t_far)
            if c == 0:
                # du ~ 0: never crosses; inside slab -> [0, smax].
                inside = prep["inside0"]
                t_in = jnp.where(small, jnp.where(inside, 0.0, inf), t_in)
                t_out = jnp.where(
                    small, jnp.where(inside, smax, -inf), t_out)
                ws = prep["pre"][0]
            else:
                # c >= 1 slabs sit strictly ahead (slab width 1 px <
                # spacing cell_px), so the origin is never inside them.
                t_in = jnp.where(small, inf, t_in)
                t_out = jnp.where(small, -inf, t_out)
                ws = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(pos_dir, a, b),
                    prep["pre"][c], prep["pre"][-c])
            t_in = jnp.maximum(t_in, 0.0)
            t_out_c = jnp.minimum(t_out, smax)
            # Strict: a zero-measure touch (origin exactly on the slab's
            # half-open exit face, gu == line_u + 1) is not a crossing.
            window = t_in < t_out_c
            valid_k = (k >= 0) & (k < n_lines)
            # Rows (v-pixels) touched inside the slab.
            v_in = gv + t_in * dv
            v_out = gv + t_out_c * dv
            r_in = jnp.floor(v_in).astype(jnp.int32)
            r_out = jnp.floor(v_out).astype(jnp.int32)
            lo_r = jnp.minimum(r_in, r_out)
            hi_r = jnp.maximum(r_in, r_out)
            # Any set pixel in rows [lo_r, hi_r] of the line, and the first
            # touched row along the ray direction (garbage when no bit is
            # set — `any_hit` gates it out of `ok`).
            any_hit, rr = band_scan(ws, lo_r, hi_r, fwd, span)
            # Entry time into that row band.
            row_edge = jnp.where(fwd, rr, rr + 1).astype(jnp.float32)
            t_row = (row_edge - gv) * inv_dv
            t_row = jnp.where(small_v, 0.0, t_row)
            s_hit = jnp.maximum(t_in, t_row)
            ok = window & valid_k & any_hit & (s_hit < smax)
            best = jnp.minimum(best, jnp.where(ok, s_hit, inf))
        return best

    def prepare(ox, oy, max_range):
        """Direction-independent context for casts from (ox, oy): grid
        coords, in-map test, and the per-axis preselected candidate words.
        The beam-weight kernel calls this ONCE per particle tile and then
        casts every beam with `cast_prepared` — the word-table select
        chains leave the beam loop.
        """
        # max_range must be a static Python float (it is cfg.max_range):
        # the candidate-slab count derives from it.
        max_range = float(max_range)
        gx = (ox - origin_x) / resolution
        gy = (oy - origin_y) / resolution
        smax_f = max_range / resolution
        # Origin slab + every gridline reachable within smax (spacing =
        # cell_px pixel units along the axis; |direction| <= 1).
        n_cand = int(np.ceil(smax_f / cell_px)) + 1
        span = int(np.ceil(smax_f)) + 2
        # Reference semantics: the march breaks on the first out-of-map
        # sample, so out-of-map origins return max_range
        # (monte_carlo.cpp:374 via worldToMap failure; DDA matches).
        inb = ((gx >= 0.0) & (gy >= 0.0)
               & (gx < float(w)) & (gy < float(h)))
        return dict(
            gx=gx, gy=gy, inb=inb, smax=jnp.float32(smax_f),
            n_cand=n_cand, span=span,
            v=_axis_prepare(gx, gy, v_scan, n_v, n_cand),
            h=_axis_prepare(gy, gx, h_scan, n_h, n_cand))

    def cast_prepared(ctx, dx, dy):
        """First-hit distance along a UNIT direction from a prepared
        origin (see `prepare`)."""
        smax, n_cand, span = ctx["smax"], ctx["n_cand"], ctx["span"]
        sv = _axis_hits(ctx["gx"], ctx["gy"], dx, dy, n_v, v_scan,
                        ctx["v"], smax, n_cand, span)
        sh = _axis_hits(ctx["gy"], ctx["gx"], dy, dx, n_h, h_scan,
                        ctx["h"], smax, n_cand, span)
        s = jnp.minimum(jnp.minimum(sv, sh), smax)
        s = jnp.where(ctx["inb"], s, smax)
        return (s * resolution).astype(jnp.float32)

    def cast_dir(ox, oy, dx, dy, max_range):
        """First-hit distance along a UNIT direction (dx, dy)."""
        return cast_prepared(prepare(ox, oy, max_range), dx, dy)

    def cast(ox, oy, angle, max_range):
        return cast_dir(ox, oy, jnp.cos(angle), jnp.sin(angle), max_range)

    cast.cast_dir = cast_dir
    cast.prepare = prepare
    cast.cast_prepared = cast_prepared
    return cast


class AnalyticCasterCache:
    _cache: dict = {}

    @classmethod
    def get(cls, m) -> Optional[Callable]:
        occ = np.asarray(m.occ)
        key = occ.tobytes()
        if key not in cls._cache:
            cls._cache[key] = make_analytic_caster(
                occ, float(m.resolution), float(m.origin_x),
                float(m.origin_y))
        return cls._cache[key]
