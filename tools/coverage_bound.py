"""Physical coverage budget per world family: how much of a maze CAN any
explorer cover in T ticks at wander speed?

A perfect maze's cell graph is a TREE: a walk visiting all n cells
traverses >= 2*(n-1) - ecc edges (DFS traversal, returning everywhere
except the longest final branch; ecc = the farthest-cell distance from
start).  With the LIDAR seeing only the current corridor (max_range
1.0 m < 2 cells through walls), observed edges track visited cells
closely, so edge travel is the binding budget.  Room worlds (BSP) are
not trees; the MST bound below is a LOWER bound on the needed travel
(real walks do better per-edge via open-room visibility).

    python tools/coverage_bound.py --ticks 1200
"""
import argparse
import os.path as osp
import sys
from collections import deque

import numpy as np

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))


def bfs_dists(walls, start):
    from montecarlolocalisation.config import (WALL_RIGHT, WALL_TOP,
                                                   WALL_LEFT, WALL_BOTTOM)
    R, C = walls.shape[:2]
    dist = -np.ones((R, C), int)
    dist[start] = 0
    q = deque([start])
    step = {WALL_RIGHT: (0, 1), WALL_TOP: (-1, 0), WALL_LEFT: (0, -1),
            WALL_BOTTOM: (1, 0)}
    while q:
        r, c = q.popleft()
        for e, (dr, dc) in step.items():
            if walls[r, c, e]:
                continue
            nr, nc = r + dr, c + dc
            if 0 <= nr < R and 0 <= nc < C and dist[nr, nc] < 0:
                dist[nr, nc] = dist[r, c] + 1
                q.append((nr, nc))
    return dist


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=1200)
    ap.add_argument("--speed", type=float, default=0.04,
                    help="m/tick straight-line (the scripted wanderer's "
                         "measured rate; frontier base_speed 8 ~ 0.033)")
    ap.add_argument("--maps", type=int, default=8)
    args = ap.parse_args()

    from montecarlolocalisation.maps import generator
    from montecarlolocalisation.maps.grid import from_walls

    budget_m = args.ticks * args.speed
    print(f"budget: {args.ticks} ticks x {args.speed} m/tick = "
          f"{budget_m:.0f} m of travel; cell edge 0.8 m")
    for style, rows, cols in (("rooms", 6, 6), ("rooms", 8, 8),
                              ("maze", 10, 10)):
        gen = (generator.generate_rooms if style == "rooms"
               else generator.generate_maze)
        walks, eccs, frac = [], [], []
        for i in range(args.maps):
            walls = np.asarray(
                from_walls(gen(rows, cols, seed=1000 + i)).walls, bool)
            n = rows * cols
            # count open internal edges (graph edges)
            from montecarlolocalisation.config import WALL_RIGHT, \
                WALL_BOTTOM
            edges = int((~walls[:, :-1, WALL_RIGHT]).sum()
                        + (~walls[:-1, :, WALL_BOTTOM]).sum())
            d = bfs_dists(walls, (1, 1))
            ecc = int(d.max())
            # spanning-tree traversal bound: 2*(n-1) - ecc edge moves
            walk_edges = 2 * (n - 1) - ecc
            walk_m = walk_edges * 0.8
            walks.append(walk_m)
            eccs.append(ecc)
            frac.append(min(1.0, budget_m / walk_m))
        print(f"{style} {rows}x{cols}: cells {rows*cols}, spanning-walk "
              f"bound {np.mean(walks):.0f} m (ecc {np.mean(eccs):.0f}) -> "
              f"min ticks for FULL visit {np.mean(walks)/args.speed:.0f}; "
              f"travel-bounded coverage at {args.ticks} ticks <= "
              f"{np.mean(frac):.2f}")


if __name__ == "__main__":
    main()
