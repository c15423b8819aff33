"""Planning tests: BFS (native + Python parity), Held-Karp, executor, mission."""
import math
import os.path as osp

import numpy as np
import pytest

from montecarlolocalisation.config import (
    DIR_RIGHT, DIR_UP, DIR_LEFT, DIR_DOWN,
)
from montecarlolocalisation.maps import maze
from montecarlolocalisation.planning import bfs, tsp, executor, mission
from montecarlolocalisation.native.build import load_planner

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")
WALLS = maze.walls_to_tensor(maze.load_map_file(MAP_PATH))


def test_native_planner_builds():
    assert load_planner() is not None, "native planner failed to build"


def test_bfs_trivial_and_adjacent():
    assert bfs.bfs_path(WALLS, (0, 0), (0, 0)) == [(0, 0)]
    # (0,0)=[T,L,R]: right is walled, bottom open -> (1,0).
    p = bfs.bfs_path(WALLS, (0, 0), (1, 0))
    assert p == [(0, 0), (1, 0)]


def test_bfs_respects_walls():
    # (0,0) -> (0,1): direct right blocked by R wall of (0,0) (and L of (0,1)).
    p = bfs.bfs_path(WALLS, (0, 0), (0, 1))
    assert len(p) > 2
    assert p[0] == (0, 0) and p[-1] == (0, 1)
    # Every step is adjacent and unblocked.
    for (r0, c0), (r1, c1) in zip(p, p[1:]):
        d = {(0, 1): 0, (-1, 0): 1, (0, -1): 2, (1, 0): 3}[(r1 - r0, c1 - c0)]
        assert not WALLS[r0, c0, d], f"path crosses wall at {(r0, c0)} dir {d}"


def test_bfs_native_matches_python():
    cells = [(0, 0), (5, 5), (2, 3), (4, 1), (0, 5), (3, 3)]
    for a in cells:
        for b in cells:
            native = bfs.bfs_path(WALLS, a, b)
            py = bfs.bfs_path_py(WALLS, a, b)
            assert len(native) == len(py), (a, b)
            if native:
                assert native[0] == py[0] and native[-1] == py[-1]


def test_all_pairs_symmetric_lengths():
    nodes = [(0, 0), (2, 3), (5, 5)]
    d = bfs.all_pairs_distances(WALLS, nodes)
    assert d.shape == (3, 3)
    assert (np.diag(d) == 1).all()  # path includes start node
    assert (d == d.T).all()


def test_held_karp_reference_selection_quirk():
    # Line graph 0-1-2-3.  The reference picks the final node by
    # dp + dist-back-to-0 (executeChallenge.cpp:219-226) with strict-< tie
    # break: all closed costs tie at 6, so the first candidate (end at 1,
    # open tour 0->3->2->1, cost 5) wins over the shorter open tour
    # 0->1->2->3 (cost 3).  Preserved quirk.
    d = np.array([
        [0, 1, 2, 3],
        [1, 0, 1, 2],
        [2, 1, 0, 1],
        [3, 2, 1, 0]])
    cost, order = tsp.held_karp(d)
    assert order == [0, 3, 2, 1]
    assert cost == 5
    assert sorted(order) == [0, 1, 2, 3]


def test_held_karp_native_matches_python():
    rng = np.random.default_rng(0)
    for n in (2, 3, 5, 7):
        d = rng.integers(1, 20, (n, n)).astype(np.int32)
        np.fill_diagonal(d, 0)
        c_n, o_n = tsp.held_karp(d)
        c_p, o_p = tsp.held_karp_py(d)
        assert c_n == c_p, (n, c_n, c_p)
        assert o_n[0] == 0 and o_p[0] == 0


def test_plan_tour_on_default_map():
    gold = [(0, 2), (2, 3), (4, 0)]  # gold.txt
    cost, order = tsp.plan_tour(WALLS, (5, 0), gold)
    assert sorted(order) == sorted(gold)
    assert cost > 0


def test_path_to_actions_roundtrip():
    p = [(0, 0), (1, 0), (1, 1), (0, 1)]
    acts = executor.path_to_actions(p)
    assert acts == [DIR_DOWN, DIR_RIGHT, DIR_UP]


def test_direction_angles():
    assert executor.direction_to_angle(DIR_RIGHT) == 0.0
    assert executor.direction_to_angle(DIR_UP) == pytest.approx(-math.pi / 2)
    assert executor.direction_to_angle(DIR_DOWN) == pytest.approx(math.pi / 2)
    # rotate_to_dir normalizes.
    assert executor.rotate_to_dir(DIR_RIGHT, math.pi / 2) == pytest.approx(
        -math.pi / 2)


def test_vector_to_next_cell_snap_and_move():
    # Off-grid -> snap to nearest 0.8 multiple (execute_plan_server.cpp:295).
    t = executor.vector_to_next_cell(0.93, 1.18, DIR_RIGHT)
    assert t.is_snap
    assert t.target_x == pytest.approx(0.8) and t.target_y == pytest.approx(0.8)
    # On-lattice (0.4 multiples) -> one-cell move.
    t = executor.vector_to_next_cell(1.2, 0.4, DIR_UP)
    assert not t.is_snap
    assert t.target_y == pytest.approx(0.4 - 0.8)


def test_plan_step_command_diffs():
    cmd = executor.plan_step_command(0.4, 0.4, 0.0, DIR_RIGHT, DIR_RIGHT)
    assert (cmd["local_x"], cmd["local_y"]) == (0.8, 0.0)
    cmd = executor.plan_step_command(0.4, 0.4, 0.0, DIR_RIGHT, DIR_DOWN)
    assert (cmd["local_x"], cmd["local_y"]) == (0.0, 0.8)  # diff 3
    cmd = executor.plan_step_command(0.4, 0.4, 0.0, DIR_DOWN, DIR_RIGHT)
    assert (cmd["local_x"], cmd["local_y"]) == (0.0, -0.8)  # diff -3


def test_parse_waypoints_and_mission():
    gold = mission.parse_waypoints("[[0,2], [2,3], [4,0]]")
    assert gold == [(0, 2), (2, 3), (4, 0)]
    pickup = mission.parse_waypoints("[[1,0], [3,5]]")
    plan = mission.plan_mission(WALLS, (5, 0), gold, pickup)
    assert len(plan.legs) == 4  # 3 gold + 1 pickup
    assert {leg.goal for leg in plan.legs[:3]} == set(gold)
    assert plan.legs[-1].goal in pickup
    assert plan.legs[-1].shutdown_after
    assert plan.legs[-1].song == mission.SONG_PICKUP
    # Legs chain: each path starts where the previous ended.
    cur = (5, 0)
    for leg in plan.legs:
        assert leg.path[0] == cur and leg.path[-1] == leg.goal
        cur = leg.goal


def test_bfs_ragged_padded_cells_unreachable():
    """Ragged-row padded non-cells are fully walled: BFS must not route
    through them (the raster marks them occupied; the reference planner
    reads them out of bounds — UB)."""
    ragged = [[[], []], [[]]]  # row 1 is short: (1,1) is a non-cell
    t = maze.walls_to_tensor(ragged)
    assert t[1, 1].all()  # fully walled
    # (0,1) -> (1,1): the padded cell can't be exited, so any path THROUGH
    # it is impossible; direct entry only if the source lacks the wall.
    path = bfs.bfs_path(t, (1, 0), (1, 1))
    # From (1,0) (no walls listed) entry is allowed by source-only semantics
    # (reference behavior), but (1,1) is a dead end: no path may CONTINUE.
    if path:
        assert path[-1] == (1, 1)
    # No route (0,0)->(0,1) may pass through (1,1): the only real route is
    # direct (both cells open).
    p = bfs.bfs_path(t, (0, 0), (0, 1))
    assert (1, 1) not in p


def test_simplify_path_identity_on_grid_paths():
    # Reference quirk (moveToPosition_server.cpp:287-312): simplifyPath's
    # skip test is GRAPH adjacency, and buildGraphFromWallArray only ever
    # produces one-step edges — so a skip of >= 2 cells is never adjacent
    # and the function is an identity on any valid grid path (straight
    # lines included).  Likely why the reference never calls it.
    walls = np.zeros((1, 5, 4), dtype=np.uint8)
    path = [(0, c) for c in range(5)]
    assert bfs.simplify_path(walls, path) == path


def test_simplify_path_short_paths_unchanged():
    walls = np.zeros((2, 2, 4), dtype=np.uint8)
    assert bfs.simplify_path(walls, []) == []
    assert bfs.simplify_path(walls, [(0, 0)]) == [(0, 0)]
    assert bfs.simplify_path(walls, [(0, 0), (0, 1)]) == [(0, 0), (0, 1)]


def test_simplify_path_keeps_turns():
    # L-shaped path in an open grid: (0,0)->(0,1)->(1,1).  The skip pair
    # (0,0)->(1,1) is NOT adjacent (diagonal), so the corner survives.
    walls = np.zeros((2, 2, 4), dtype=np.uint8)
    path = [(0, 0), (0, 1), (1, 1)]
    assert bfs.simplify_path(walls, path) == path


def test_simplify_path_reference_semantics_on_maze():
    # On the real maze the simplified path's consecutive pairs are NOT
    # required to be adjacent (reference keeps only turn anchors); the
    # original endpoints survive and the output is a subsequence.
    p = bfs.bfs_path(WALLS, (0, 0), (5, 5))
    s = bfs.simplify_path(WALLS, p)
    assert s[0] == p[0] and s[-1] == p[-1]
    it = iter(p)
    assert all(node in it for node in s), "not a subsequence"
    assert len(s) <= len(p)


def test_generate_subgoals_compresses_straights():
    # RR UUU L from (0.4, 0.4): three segments -> three waypoints at the
    # segment ends (avf.cpp:187-222; y-down world so UP is -y).
    plan = [DIR_RIGHT, DIR_RIGHT, DIR_UP, DIR_UP, DIR_UP, DIR_LEFT]
    goals = executor.generate_subgoals((0.4, 0.4), plan)
    want = [(2.0, 0.4), (2.0, -2.0), (1.2, -2.0)]
    assert len(goals) == 3
    for (gx, gy), (wx, wy) in zip(goals, want):
        assert abs(gx - wx) < 1e-6 and abs(gy - wy) < 1e-6


def test_generate_subgoals_uturn_and_empty():
    assert executor.generate_subgoals((0.0, 0.0), []) == []
    # U-turn RIGHT then LEFT: the intermediate waypoint at the far end is
    # emitted before doubling back (the count==1 opposite-direction case
    # the reference's comment calls out).
    goals = executor.generate_subgoals((0.0, 0.0), [DIR_RIGHT, DIR_LEFT])
    assert len(goals) == 2
    assert abs(goals[0][0] - 0.8) < 1e-6 and abs(goals[0][1]) < 1e-6
    assert abs(goals[1][0]) < 1e-6 and abs(goals[1][1]) < 1e-6


def test_generate_subgoals_single_run():
    goals = executor.generate_subgoals((0.4, 0.4), [DIR_DOWN] * 4)
    assert goals == [(0.4, 0.4 + 4 * 0.8)]
