"""Device-side map container and world<->grid transforms (jit-safe).

Reproduces the coordinate conventions of the reference MCL node:
  * worldToMap (monte_carlo.cpp:298-315): pixel = trunc((w - origin)/res),
    C++ static_cast<int> truncation-toward-zero included (so world coords in
    (-res, 0) land on pixel 0 and count as in-bounds — a reference quirk that
    affects particles hugging the outer wall).
  * getCell (monte_carlo.cpp:317-321): data[row=my][col=mx], occupancy > 50
    means wall.
  * isInsideMap (monte_carlo.cpp:685-692): world-extent bounds.
  * isValidPos (monte_carlo.cpp:331-349): 9-point stencil, +-0.1 m offsets.

World x runs along raster columns, world y along raster rows (y-down row
indexing; see publish_map_rviz.cpp:306-437 and SURVEY.md §2.3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GridConfig
from . import maze, raster


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MazeMap:
    """Occupancy map on device.  `occ` is a bool [H, W] (True = wall)."""

    occ: jax.Array                       # [H, W] bool, row-major (y, x)
    occ_dilated: jax.Array               # [H, W] bool 3x3 dilation (validity)
    occ_f: jax.Array                     # [H, W] bf16 (one-hot lookups)
    dil_f: jax.Array                     # [H, W] bf16 dilated
    walls: jax.Array                     # [R, C, 4] bool wall tensor
    row_lengths: jax.Array               # [R] int32 (ragged-row accounting)
    resolution: float = dataclasses.field(metadata=dict(static=True), default=0.1)
    origin_x: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    origin_y: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    cell_meters: float = dataclasses.field(metadata=dict(static=True), default=0.8)

    @property
    def height(self) -> int:
        return self.occ.shape[0]

    @property
    def width(self) -> int:
        return self.occ.shape[1]

    @property
    def n_rows(self) -> int:
        return self.walls.shape[0]

    @property
    def n_cols(self) -> int:
        return self.walls.shape[1]

    @property
    def extent_x(self) -> float:
        return self.origin_x + self.width * self.resolution

    @property
    def extent_y(self) -> float:
        return self.origin_y + self.height * self.resolution


def _finalize(occ: np.ndarray, walls_t: np.ndarray, row_lens: np.ndarray,
              resolution: float, origin_x: float, origin_y: float,
              cell_meters: float) -> MazeMap:
    """Derived rasters (dilation, bf16) + device upload."""
    # 3x3 dilation: the isValidPos +-0.1 m stencil equals one lookup into the
    # dilated raster (offsets are exactly one pixel; border clipping matches
    # the out-of-map-is-free rule).  Precomputed once on host.
    dil = np.zeros_like(occ)
    h, w = occ.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            yd = slice(max(0, -dy), h + min(0, -dy))
            xd = slice(max(0, -dx), w + min(0, -dx))
            dil[yd, xd] |= occ[ys, xs]
    return MazeMap(
        occ=jnp.asarray(occ),
        occ_dilated=jnp.asarray(dil),
        occ_f=jnp.asarray(occ, jnp.bfloat16),
        dil_f=jnp.asarray(dil, jnp.bfloat16),
        walls=jnp.asarray(walls_t),
        row_lengths=jnp.asarray(row_lens),
        resolution=resolution,
        origin_x=origin_x,
        origin_y=origin_y,
        cell_meters=cell_meters,
    )


def from_walls(
    walls: Sequence[Sequence[Sequence[int]]],
    grid: GridConfig = GridConfig(),
) -> MazeMap:
    occ = raster.rasterize_walls(walls, grid) > grid.occupied_threshold
    return _finalize(occ, maze.walls_to_tensor(walls), maze.row_lengths(walls),
                     grid.resolution, grid.origin_x, grid.origin_y,
                     grid.cell_meters)


def from_map_file(path: str, grid: GridConfig = GridConfig()) -> MazeMap:
    return from_walls(maze.load_map_file(path), grid)


def synthesize_walls(occ: np.ndarray, cell_px: int) -> np.ndarray:
    """Wall tensor [R, C, 4] from an arbitrary occupancy raster.

    Overlays the reference's 0.8 m cell lattice (cell (r, c) spans pixels
    [r*cell_px, (r+1)*cell_px] x [c*cell_px, ...]) and declares a wall on
    an edge when its OPEN band — the edge's pixels excluding the two
    shared corner pixels — contains any occupied pixel.  Corners are
    excluded because perpendicular walls share them: on the reference's
    own rasters a TOP-only cell would otherwise also report LEFT/RIGHT.
    Edges outside the raster count as walls, a cell whose interior
    contains occupied pixels (an obstacle blob, unexplored space) becomes
    all-walls, and walls are marked on BOTH adjacent cells, so the
    BFS/TSP planner sees symmetric blocking.  For maze rasters the result
    is connectivity-identical to the source wall list (tests/test_pgm.py).
    """
    occ = np.asarray(occ).astype(bool)
    h, w = occ.shape
    n_rows = max(1, (h - 1) // cell_px)
    n_cols = max(1, (w - 1) // cell_px)
    t = np.zeros((n_rows, n_cols, 4), dtype=bool)

    def band_any(r0, r1, c0, c1):
        if r0 >= h or c0 >= w or r1 > h or c1 > w:
            return True  # edge (partly) outside the raster: walled
        return bool(occ[r0:r1, c0:c1].any())

    from ..config import WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM

    for r in range(n_rows):
        for c in range(n_cols):
            r0, c0 = r * cell_px, c * cell_px
            t[r, c, WALL_TOP] = band_any(r0, r0 + 1, c0 + 1, c0 + cell_px)
            t[r, c, WALL_BOTTOM] = band_any(
                r0 + cell_px, r0 + cell_px + 1, c0 + 1, c0 + cell_px)
            t[r, c, WALL_LEFT] = band_any(r0 + 1, r0 + cell_px, c0, c0 + 1)
            t[r, c, WALL_RIGHT] = band_any(
                r0 + 1, r0 + cell_px, c0 + cell_px, c0 + cell_px + 1)
            interior = occ[r0 + 1: min(r0 + cell_px, h),
                           c0 + 1: min(c0 + cell_px, w)]
            if interior.size == 0 or interior.any():
                t[r, c, :] = True
    return t


def from_raster(
    occ: np.ndarray,
    resolution: float = 0.1,
    origin_x: float = 0.0,
    origin_y: float = 0.0,
    cell_meters: float = 0.8,
) -> MazeMap:
    """MazeMap from an arbitrary boolean occupancy raster (True = wall).

    The entry point for imported maps (maps/pgm.py) and user-supplied
    rasters.  The filter core (ray cast, likelihood, validity, Pallas
    kernels) uses the raster directly; the maze-cell layer (uniform
    sampler, BFS/TSP planner) runs on a `synthesize_walls` overlay of the
    reference's cell lattice.  Gridline-structured rasters keep every
    fast path (analytic caster included); others fall back to the
    chain-march/DDA paths automatically.
    """
    occ = np.asarray(occ).astype(bool)
    cell_px = max(1, int(round(cell_meters / resolution)))
    walls_t = synthesize_walls(occ, cell_px)
    row_lens = np.full((walls_t.shape[0],), walls_t.shape[1], dtype=np.int32)
    return _finalize(occ, walls_t, row_lens, float(resolution),
                     float(origin_x), float(origin_y), float(cell_meters))


def world_to_map(m: MazeMap, wx, wy):
    """World -> pixel indices + in-bounds mask (monte_carlo.cpp:298-315).

    Uses C++ truncation-toward-zero semantics (astype int32), not floor.
    """
    mx = ((wx - m.origin_x) / m.resolution).astype(jnp.int32)
    my = ((wy - m.origin_y) / m.resolution).astype(jnp.int32)
    inb = (mx >= 0) & (my >= 0) & (mx < m.width) & (my < m.height)
    return mx, my, inb


def get_cell(m: MazeMap, mx, my):
    """Occupancy at pixel (clamped gather; caller masks out-of-bounds)."""
    mx = jnp.clip(mx, 0, m.width - 1)
    my = jnp.clip(my, 0, m.height - 1)
    return m.occ[my, mx]


def is_occupied(m: MazeMap, wx, wy):
    """True when the pixel under (wx, wy) is a wall; False out-of-map
    (monte_carlo.cpp:322-329)."""
    mx, my, inb = world_to_map(m, wx, wy)
    return inb & get_cell(m, mx, my)


def is_inside_map(m: MazeMap, wx, wy):
    """World-extent bounds check (monte_carlo.cpp:685-692)."""
    return (
        (wx >= m.origin_x)
        & (wx < m.extent_x)
        & (wy >= m.origin_y)
        & (wy < m.extent_y)
    )


# 9-point stencil offsets (monte_carlo.cpp:334-338), scaled by the offset.
_STENCIL = np.array(
    [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)],
    dtype=np.float32,
)


def is_valid_pos_stencil(m: MazeMap, wx, wy, offset: float = 0.1):
    """Reference-exact 9-point stencil check (monte_carlo.cpp:331-349)."""
    wx = jnp.asarray(wx)
    sx = wx[..., None] + offset * _STENCIL[:, 0]
    sy = jnp.asarray(wy)[..., None] + offset * _STENCIL[:, 1]
    hit = is_occupied(m, sx, sy)
    return is_inside_map(m, wx, jnp.asarray(wy)) & ~jnp.any(hit, axis=-1)


def is_valid_pos(m: MazeMap, wx, wy, offset: float = 0.1):
    """Free-space check: inside map and no wall within the +-offset stencil
    (monte_carlo.cpp:331-349 isValidPos).

    Fast path: when the stencil offset equals one pixel (the reference's
    0.1 m at 0.1 m/px), the 9 lookups collapse to ONE lookup into the
    precomputed 3x3-dilated raster — identical semantics away from exact
    pixel-boundary float ties (sub-1e-6 measure; use is_valid_pos_stencil
    for bit-parity studies)."""
    if abs(offset - m.resolution) > 1e-9:
        return is_valid_pos_stencil(m, wx, wy, offset)
    wx = jnp.asarray(wx)
    wy = jnp.asarray(wy)
    mx, my, inb = world_to_map(m, wx, wy)
    mx = jnp.clip(mx, 0, m.width - 1)
    my = jnp.clip(my, 0, m.height - 1)
    hit = inb & m.occ_dilated[my, mx]
    return is_inside_map(m, wx, wy) & ~hit


def world_to_cell(wx, wy, cell_meters: float = 0.8):
    """World (x, y) -> maze (row, col) (monte_carlo.cpp:975-979).

    col = floor((wx - 0.4)/0.8 + 0.5), row likewise from wy.
    """
    col = jnp.floor((wx - 0.5 * cell_meters) / cell_meters + 0.5).astype(jnp.int32)
    row = jnp.floor((wy - 0.5 * cell_meters) / cell_meters + 0.5).astype(jnp.int32)
    return row, col


def cell_center(row, col, cell_meters: float = 0.8):
    """Maze (row, col) -> world center (monte_carlo.cpp:394-407 to_cell)."""
    x = col * cell_meters + 0.5 * cell_meters
    y = row * cell_meters + 0.5 * cell_meters
    return x, y
