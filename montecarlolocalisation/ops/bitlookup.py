"""Gather-free map lookups: bit-packed select chains over a static raster.

A map lookup with no memory traffic at all, for the (static-per-jit) maze
raster — the fused beam-weight kernel's raster probes:

  * each raster row packs into ceil(W/32) uint32 bit words;
  * `table[my, mx]` becomes a chain of lane-wise selects against SCALAR
    constants (the packed words, baked into the program at trace time),
    followed by a variable shift — a pure elementwise computation XLA fuses
    with the surrounding ray-march arithmetic: zero memory traffic.
  * maze rasters place wall pixels only on multiple-of-8 gridline rows/cols
    (publish_map_rviz.cpp drawing rules, rectangular maps), which shrinks
    the select chain from H entries to H/8: ~40 VPU ops per lookup.

The factory runs on HOST values (numpy) at trace time, so it requires the
map to be a concrete (non-traced) array — true whenever the MazeMap is
closed over by jit, the normal usage.  Callers fall back to gather/one-hot
paths for traced maps (e.g. inside vmap-over-maps).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import jax.numpy as jnp
import numpy as np


def _pack_rows(table: np.ndarray) -> List[Tuple[int, ...]]:
    """[H, W] bool -> per-row tuples of ceil(W/32) uint32 bit words."""
    h, w = table.shape
    n_words = (w + 31) // 32
    rows = []
    for r in range(h):
        words = [0] * n_words
        for c in range(w):
            if table[r, c]:
                words[c >> 5] |= 1 << (c & 31)
        rows.append(tuple(words))
    return rows


def _select_words(idx, rows: List[Tuple[int, ...]]):
    """Select a row's word tuple by idx via chains of scalar-constant
    selects (one chain per word column; all-zero columns are free)."""
    n_words = len(rows[0]) if rows else 1
    out = []
    for j in range(n_words):
        wj = jnp.zeros_like(idx, dtype=jnp.uint32)
        for h, words in enumerate(rows):
            if words[j]:
                wj = jnp.where(idx == h, jnp.uint32(words[j]), wj)
        out.append(wj)
    return out


def _test_bit(words, col):
    """Bit `col` of the multi-word value (word j holds bits 32j..32j+31)."""
    col = col.astype(jnp.uint32)
    shift = col & jnp.uint32(31)
    word_idx = col >> jnp.uint32(5)
    w = words[0]
    for j in range(1, len(words)):
        w = jnp.where(word_idx == j, words[j], w)
    return ((w >> shift) & jnp.uint32(1)) == 1


def _is_gridline_structured(table: np.ndarray, cell_px: int = 8) -> bool:
    """True when wall pixels only sit on multiple-of-cell_px rows/cols."""
    h, w = table.shape
    rows = np.arange(h) % cell_px == 0
    cols = np.arange(w) % cell_px == 0
    off_grid = table & ~rows[:, None] & ~cols[None, :]
    return not off_grid.any()


def make_bit_lookup(table: np.ndarray, cell_px: int = 8) -> Callable:
    """Build `lookup(my, mx) -> bool` (False out of range) for a static
    0/1 table of ANY size.  Chooses the gridline-decomposed fast path when
    possible."""
    table = np.asarray(table).astype(bool)
    h, w = table.shape

    if _is_gridline_structured(table, cell_px):
        # Horizontal gridline rows: rows r*cell_px, bits over all cols.
        n_hrows = (h - 1) // cell_px + 1
        hrows = _pack_rows(table[::cell_px])           # [n_hrows][words(W)]
        # Vertical gridline cols: cols c*cell_px, bits over all rows.
        n_vcols = (w - 1) // cell_px + 1
        vcols = _pack_rows(table[:, ::cell_px].T)      # [n_vcols][words(H)]
        # Off-gridline pixels select the sentinel index n_hrows/n_vcols,
        # which matches no chain entry and falls through to the
        # zero-initialized accumulator (no explicit zero row needed).

        def lookup(my, mx):
            inb = (my >= 0) & (mx >= 0) & (my < h) & (mx < w)
            myc = jnp.clip(my, 0, h - 1)
            mxc = jnp.clip(mx, 0, w - 1)
            on_h = (myc % cell_px) == 0
            on_v = (mxc % cell_px) == 0
            h_idx = jnp.where(on_h, myc // cell_px, n_hrows)
            v_idx = jnp.where(on_v, mxc // cell_px, n_vcols)
            hw = _select_words(h_idx, hrows)
            vw = _select_words(v_idx, vcols)
            hit_h = _test_bit(hw, mxc)
            hit_v = _test_bit(vw, myc)
            return inb & (hit_h | hit_v)

        return lookup

    # General path: full per-row select chain.
    rows = _pack_rows(table)

    def lookup_general(my, mx):
        inb = (my >= 0) & (mx >= 0) & (my < h) & (mx < w)
        myc = jnp.clip(my, 0, h - 1)
        mxc = jnp.clip(mx, 0, w - 1)
        ws = _select_words(myc, rows)
        return inb & _test_bit(ws, mxc)

    return lookup_general


class MapBitTables:
    """Cached bit-lookup closures for a MazeMap (built once per map)."""

    _cache: dict = {}

    @classmethod
    def get(cls, m) -> Tuple[Callable, Callable]:
        """(occ_lookup, dilated_lookup) for a CONCRETE MazeMap."""
        occ = np.asarray(m.occ)
        key = occ.tobytes()
        hit = cls._cache.get(key)
        if hit is None:
            hit = (make_bit_lookup(occ),
                   make_bit_lookup(np.asarray(m.occ_dilated)))
            cls._cache[key] = hit
        return hit


def is_concrete_map(m) -> bool:
    """True when the map arrays hold real values (not tracers)."""
    import jax.core

    return not isinstance(m.occ, jax.core.Tracer)
