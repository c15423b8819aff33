"""Random maze generation for sweep/datagen configs.

The reference ships one hand-written 6x6 maze (map.txt).  Sweeps
(BASELINE.md config 4: episodes x randomized maps x noise seeds) need
arbitrarily many: this generates perfect mazes (spanning-tree corridors,
every cell reachable) with optional extra openings, in the same nested
wall-list format as map.txt — both neighbors list their shared wall,
matching the hand-written map's convention.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM

_OPP = {WALL_RIGHT: WALL_LEFT, WALL_LEFT: WALL_RIGHT,
        WALL_TOP: WALL_BOTTOM, WALL_BOTTOM: WALL_TOP}
_DELTA = {WALL_RIGHT: (0, 1), WALL_TOP: (-1, 0), WALL_LEFT: (0, -1),
          WALL_BOTTOM: (1, 0)}


def generate_maze(rows: int = 6, cols: int = 6, seed: int = 0,
                  extra_openings: int = 0) -> List[List[List[int]]]:
    """Random perfect maze -> nested wall lists (map.txt format).

    Recursive-backtracker spanning tree; `extra_openings` removes that many
    additional internal walls to create loops (less aliasing, easier
    localization — useful for curriculum sweeps).
    """
    rng = np.random.default_rng(seed)
    # walls[r][c] = set of wall codes; start fully walled.
    walls = [[{WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM}
              for _ in range(cols)] for _ in range(rows)]

    def carve(r0, c0, d):
        r1, c1 = r0 + _DELTA[d][0], c0 + _DELTA[d][1]
        walls[r0][c0].discard(d)
        walls[r1][c1].discard(_OPP[d])

    visited = np.zeros((rows, cols), dtype=bool)
    stack = [(rng.integers(rows), rng.integers(cols))]
    visited[stack[0]] = True
    while stack:
        r, c = stack[-1]
        options = []
        for d, (dr, dc) in _DELTA.items():
            nr, nc = r + dr, c + dc
            if 0 <= nr < rows and 0 <= nc < cols and not visited[nr, nc]:
                options.append(d)
        if not options:
            stack.pop()
            continue
        d = options[rng.integers(len(options))]
        carve(r, c, d)
        nr, nc = r + _DELTA[d][0], c + _DELTA[d][1]
        visited[nr, nc] = True
        stack.append((nr, nc))

    # Extra loop openings on random internal walls.
    for _ in range(extra_openings):
        for _attempt in range(64):
            r = int(rng.integers(rows))
            c = int(rng.integers(cols))
            internal = [d for d in walls[r][c]
                        if 0 <= r + _DELTA[d][0] < rows
                        and 0 <= c + _DELTA[d][1] < cols]
            if internal:
                carve(r, c, internal[rng.integers(len(internal))])
                break

    return [[sorted(walls[r][c]) for c in range(cols)] for r in range(rows)]


def generate_rooms(rows: int = 6, cols: int = 6, seed: int = 0,
                   min_room: int = 2) -> List[List[List[int]]]:
    """Office-style layout: BSP rectangular rooms + one door per wall.

    The opposite regime to `generate_maze`: long sightlines and open space
    (many beams at max range, exercising the w_rand term and the sparse-
    feature failure mode) instead of corridor aliasing.  Rooms are
    rectangles from recursive binary splits (no side smaller than
    `min_room`); every internal partition gets exactly one door cell, so
    the map stays fully connected.  Same nested wall-list format as
    map.txt (both neighbors list the shared wall).
    """
    rng = np.random.default_rng(seed)
    walls = [[set() for _ in range(cols)] for r in range(rows)]
    for c in range(cols):
        walls[0][c].add(WALL_TOP)
        walls[rows - 1][c].add(WALL_BOTTOM)
    for r in range(rows):
        walls[r][0].add(WALL_LEFT)
        walls[r][cols - 1].add(WALL_RIGHT)

    def add_vwall(r, c_left):
        """Wall between columns c_left and c_left+1 at row r."""
        walls[r][c_left].add(WALL_RIGHT)
        walls[r][c_left + 1].add(WALL_LEFT)

    def add_hwall(r_top, c):
        """Wall between rows r_top and r_top+1 at column c."""
        walls[r_top][c].add(WALL_BOTTOM)
        walls[r_top + 1][c].add(WALL_TOP)

    def split(r0, c0, r1, c1):
        """Half-open cell rectangle [r0, r1) x [c0, c1)."""
        h, w = r1 - r0, c1 - c0
        can_v = w >= 2 * min_room
        can_h = h >= 2 * min_room
        if not can_v and not can_h:
            return
        vertical = can_v and (not can_h or w >= h)
        if vertical:
            c_split = int(rng.integers(c0 + min_room, c1 - min_room + 1))
            door = int(rng.integers(r0, r1))
            for r in range(r0, r1):
                if r != door:
                    add_vwall(r, c_split - 1)
            split(r0, c0, r1, c_split)
            split(r0, c_split, r1, c1)
        else:
            r_split = int(rng.integers(r0 + min_room, r1 - min_room + 1))
            door = int(rng.integers(c0, c1))
            for c in range(c0, c1):
                if c != door:
                    add_hwall(r_split - 1, c)
            split(r0, c0, r_split, c1)
            split(r_split, c0, r1, c1)

    split(0, 0, rows, cols)
    return [[sorted(walls[r][c]) for c in range(cols)] for r in range(rows)]


def generate_map_batch(n_maps: int, rows: int = 6, cols: int = 6,
                       seed: int = 0, extra_openings: int = 0,
                       style: str = "maze"):
    """Batch of MazeMaps stacked for vmap-over-maps sweeps.

    Returns a MazeMap whose array leaves carry a leading [n_maps] axis
    (geometry is shared).  Use with the onehot lookup path (maps are traced
    under vmap).  style: "maze" (corridors), "rooms" (BSP offices), or
    "mixed" (alternating).
    """
    import jax.numpy as jnp

    from .grid import MazeMap, from_walls

    def one(i):
        use_rooms = (style == "rooms"
                     or (style == "mixed" and i % 2 == 1))
        if use_rooms:
            return generate_rooms(rows, cols, seed + i)
        return generate_maze(rows, cols, seed + i, extra_openings)

    if style not in ("maze", "rooms", "mixed"):
        raise ValueError(f"unknown style {style!r}")
    maps = [from_walls(one(i)) for i in range(n_maps)]
    stack = lambda attr: jnp.stack([getattr(m, attr) for m in maps])
    proto = maps[0]
    return MazeMap(
        occ=stack("occ"), occ_dilated=stack("occ_dilated"),
        occ_f=stack("occ_f"), dil_f=stack("dil_f"),
        walls=stack("walls"), row_lengths=stack("row_lengths"),
        resolution=proto.resolution, origin_x=proto.origin_x,
        origin_y=proto.origin_y, cell_meters=proto.cell_meters)
