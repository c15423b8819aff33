"""Map pipeline tests: parser, rasterizer golden rules, transforms.

The rasterizer must reproduce createOccupancyGrid
(publish_map_rviz.cpp:306-437) exactly; golden assertions below are
hand-derived from the drawing rules and the default 6x6 map.txt.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from montecarlolocalisation.config import (
    GridConfig, WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM,
)
from montecarlolocalisation.maps import maze, raster, grid


MAP_TEXT = """[[[T, L, R],  [T, L],    [T, R],  [T, L],  [T, B],  [T, R, B]],
[[L, R],      [L, B, R], [L, R],  [L, B],  [T],     [T, R, B]],
[[L, B],      [T],       [],      [T, R],  [L],     [T, R]],
[[L, T, B],   [R, B],    [L],     [],      [B],     [R, B]],
[[T, L],      [R, T],    [L, R],  [L],     [T, R],  [T, L, R, B]],
[[R, L, B],   [L, B],    [R, B],  [L, B],  [B],     [T, R, B]]]"""


def test_parse_map_text():
    walls = maze.parse_map_text(MAP_TEXT)
    assert len(walls) == 6
    assert all(len(r) == 6 for r in walls)
    assert walls[0][0] == [WALL_TOP, WALL_LEFT, WALL_RIGHT]
    assert walls[2][2] == []
    assert walls[4][5] == [WALL_TOP, WALL_LEFT, WALL_RIGHT, WALL_BOTTOM]


def test_walls_tensor():
    t = maze.walls_to_tensor(maze.parse_map_text(MAP_TEXT))
    assert t.shape == (6, 6, 4)
    assert t[0, 0, WALL_TOP] and t[0, 0, WALL_LEFT] and t[0, 0, WALL_RIGHT]
    assert not t[0, 0, WALL_BOTTOM]
    assert not t[2, 2].any()


def test_raster_shape_and_golden_pixels():
    walls = maze.parse_map_text(MAP_TEXT)
    r = raster.rasterize_walls(walls)
    assert r.shape == (49, 49)  # 6*8+1 (publish_map_rviz.cpp:330-331)

    # Cell (0,0) top wall: row 0, cols 0..8 inclusive.
    assert (r[0, 0:9] == 100).all()
    # Cell (0,0) left wall: rows 0..8 inclusive, col 0.
    assert (r[0:9, 0] == 100).all()
    # Right walls are only drawn on the last column: the open boundary
    # between cells (3,3)=[] and (3,4)=[B] stays free (col 32, rows 25..31;
    # row 24 pixel is painted by cell (2,4)'s left wall).
    assert (r[25:32, 32] == 0).all()
    # Cell (0,5) right wall IS drawn (last column): rows 0..7, col 48.
    assert (r[0:8, 48] == 100).all()
    # Bottom walls are only drawn on the last row / ragged edges: the open
    # boundary between (2,1)=[T] (no B) and (3,1)=[R,B] (no T) stays free at
    # row 24, cols 9..15 (col 8 painted by (3,0)'s top, col 16 by (3,2) left).
    assert (r[24, 9:16] == 0).all()
    # Cell (5,0) bottom wall: last row -> row 48, cols 1..8.
    assert (r[48, 1:9] == 100).all()
    # Interior of cell (2,2) (open cell) is free.
    assert (r[17:24, 17:24] == 0).all()


def test_raster_ragged_rows_padded_occupied():
    walls = [[[WALL_TOP], [WALL_TOP]], [[WALL_TOP]]]
    r = raster.rasterize_walls(walls)
    assert r.shape == (17, 17)
    # Row 1 is short: the missing cell (1,1) block rows 8..15, cols 8..16 occupied.
    assert (r[8:16, 8:17] == 100).all()


def test_raster_bottom_drawn_when_next_row_shorter():
    walls = [[[], [WALL_BOTTOM]], [[]]]
    r = raster.rasterize_walls(walls)
    # Cell (0,1) bottom: next row has no column 1 -> drawn at row 8, cols 9..16.
    assert (r[8, 9:17] == 100).all()


def test_world_to_map_truncation_quirk(default_map):
    m = default_map
    # static_cast<int> truncation: -0.05/0.1 -> 0, counts as in-bounds.
    mx, my, inb = grid.world_to_map(m, jnp.float32(-0.05), jnp.float32(0.25))
    assert int(mx) == 0 and int(my) == 2 and bool(inb)
    mx, my, inb = grid.world_to_map(m, jnp.float32(-0.15), jnp.float32(0.25))
    assert not bool(inb)


def test_is_occupied_and_valid_pos(default_map):
    m = default_map
    # On the outer left wall (x ~ 0) -> occupied.
    assert bool(grid.is_occupied(m, jnp.float32(0.05), jnp.float32(0.45)))
    # Center of open cell (2,2): world (0.05 offset-free) center = (2.0, 2.0).
    assert not bool(grid.is_occupied(m, jnp.float32(2.05), jnp.float32(2.05)))
    assert bool(grid.is_valid_pos(m, jnp.float32(2.05), jnp.float32(2.05)))
    # Near outer wall: stencil hits the boundary -> invalid.
    assert not bool(grid.is_valid_pos(m, jnp.float32(0.12), jnp.float32(0.45)))
    # Outside the map -> invalid.
    assert not bool(grid.is_valid_pos(m, jnp.float32(-1.0), jnp.float32(0.45)))


def test_valid_pos_vectorized(default_map):
    m = default_map
    xs = jnp.array([2.05, 0.12, -1.0], dtype=jnp.float32)
    ys = jnp.array([2.05, 0.45, 0.45], dtype=jnp.float32)
    v = grid.is_valid_pos(m, xs, ys)
    assert v.shape == (3,)
    assert list(np.asarray(v)) == [True, False, False]


def test_cell_transforms_roundtrip():
    row, col = grid.world_to_cell(jnp.float32(2.05), jnp.float32(0.45))
    assert (int(row), int(col)) == (0, 2)
    x, y = grid.cell_center(0, 2)
    assert abs(float(x) - 2.0) < 1e-6 and abs(float(y) - 0.4) < 1e-6


def test_default_map_loads(default_map):
    assert default_map.occ.shape == (49, 49)
    assert default_map.walls.shape == (6, 6, 4)


def test_native_rasterizer_matches_python():
    from montecarlolocalisation.maps.raster import (
        _rasterize_native, rasterize_walls_py,
    )
    from montecarlolocalisation.config import GridConfig

    cases = [
        maze.parse_map_text(MAP_TEXT),
        [[[WALL_TOP], [WALL_TOP]], [[WALL_TOP]]],          # ragged
        [[[], [WALL_BOTTOM]], [[]]],                        # next-row-shorter
        [[[WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM]]], # single box
    ]
    for walls in cases:
        native = _rasterize_native(walls, GridConfig())
        assert native is not None, "native rasterizer unavailable"
        py = rasterize_walls_py(walls)
        np.testing.assert_array_equal(native, py)
