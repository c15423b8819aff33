"""Map lookups as one-hot contractions, for maps that are traced values.

When the raster is itself traced (vmap over generated maps), the packed
select chains of ops/bitlookup cannot be built at trace time; the lookup
is then computed as two contractions:

    row_onehot [M, H] @ table [H, W] -> rows [M, W]
    out[m] = sum_w rows[m, w] * col_onehot[m, w]

Out-of-range indices produce
all-zero one-hots, so out-of-map lookups are False for free — exactly the
reference's worldToMap failure semantics (monte_carlo.cpp:322-329).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_lookup_2d(table_f, my, mx):
    """table_f: [H, W] bf16/f32 (0/1 values); my, mx: int arrays [...].

    Returns bool array [...]: table[my, mx] != 0, False out of range.
    """
    h, w = table_f.shape
    shape = my.shape
    myf = my.reshape(-1)
    mxf = mx.reshape(-1)
    row = jax.nn.one_hot(myf, h, dtype=table_f.dtype)        # [M, H]
    col = jax.nn.one_hot(mxf, w, dtype=table_f.dtype)        # [M, W]
    # 0/1 times 0/1 with one nonzero per row: exact at any matmul
    # precision (TF32 included), so no precision is requested.
    rows = jnp.dot(row, table_f, preferred_element_type=jnp.float32)
    val = jnp.sum(rows * col.astype(jnp.float32), axis=-1)
    return (val > 0.5).reshape(shape)


def is_occupied_onehot(m, wx, wy):
    """One-hot-matmul version of maps.grid.is_occupied."""
    mx = ((wx - m.origin_x) / m.resolution).astype(jnp.int32)
    my = ((wy - m.origin_y) / m.resolution).astype(jnp.int32)
    # No in-bounds mask needed: out-of-range one-hots are all-zero.
    return onehot_lookup_2d(m.occ_f, my, mx)


def is_valid_pos_onehot(m, wx, wy):
    """One-hot-matmul version of maps.grid.is_valid_pos (dilated raster)."""
    from ..maps.grid import is_inside_map

    mx = ((wx - m.origin_x) / m.resolution).astype(jnp.int32)
    my = ((wy - m.origin_y) / m.resolution).astype(jnp.int32)
    hit = onehot_lookup_2d(m.dil_f, my, mx)
    return is_inside_map(m, wx, wy) & ~hit
