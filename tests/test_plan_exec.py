"""execute_plan-style local-frame navigation tests."""
import numpy as np
import pytest

import os.path as osp

from montecarlolocalisation.config import (
    FilterConfig, DIR_RIGHT, DIR_DOWN, DIR_LEFT, DIR_UP,
)
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.sim import plan_exec, robot as R

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation",
                    "maps", "default_map.txt")


@pytest.fixture(scope="module")
def maze():
    return from_map_file(MAP_PATH)


def test_square_loop_returns_to_start(maze):
    cfg = FilterConfig()
    rb = R.make_robot(2.0, 2.0, 0.0)  # center of open cell (2,2)
    rb, trace = plan_exec.execute_plan(
        rb, [DIR_RIGHT, DIR_DOWN, DIR_LEFT, DIR_UP], cfg)
    # Each leg lands near the next cell center (PID exit tol 0.05 m).
    want = [(2.8, 2.0), (2.8, 2.8), (2.0, 2.8), (2.0, 2.0)]
    for (gx, gy), (wx, wy) in zip(trace, want):
        assert np.hypot(gx - wx, gy - wy) < 0.1, (trace, want)


def test_turns_by_direction_diff(maze):
    cfg = FilterConfig()
    # Facing DOWN (+y, theta=pi/2) then commanded RIGHT: diff -3 -> local
    # (0, -0.8) which from a DOWN heading is world +x.
    rb = R.make_robot(2.0, 2.0, np.pi / 2)
    rb, trace = plan_exec.execute_plan(rb, [DIR_RIGHT], cfg)
    assert np.hypot(trace[0][0] - 2.8, trace[0][1] - 2.0) < 0.1


def test_pose_provider_hook(maze):
    cfg = FilterConfig()
    rb = R.make_robot(2.0, 2.0, 0.0)
    calls = []

    def provider(r):
        calls.append(1)
        return float(r.x), float(r.y), float(r.theta)

    rb, trace = plan_exec.execute_plan(
        rb, [DIR_RIGHT], cfg, pose_provider=provider)
    assert calls, "pose provider not consulted"
    assert np.hypot(trace[0][0] - 2.8, trace[0][1] - 2.0) < 0.1


def test_subgoal_executor_one_drive_for_straight_plan(maze):
    # A 4-straight plan must issue ONE drive (one trace entry), not four,
    # and land at the compressed segment end (avf.cpp generateSubgoals).
    cfg = FilterConfig()
    rb = R.make_robot(0.4, 2.0, 0.0)  # row 2 is an open corridor
    rb, trace = plan_exec.execute_plan_subgoals(rb, [DIR_RIGHT] * 4, cfg)
    assert len(trace) == 1, trace
    assert np.hypot(trace[0][0] - (0.4 + 4 * 0.8), trace[0][1] - 2.0) < 0.15


def test_subgoal_executor_l_path(maze):
    cfg = FilterConfig()
    rb = R.make_robot(2.0, 2.0, 0.0)
    plan = [DIR_RIGHT, DIR_DOWN, DIR_DOWN]
    rb, trace = plan_exec.execute_plan_subgoals(rb, plan, cfg)
    assert len(trace) == 2, trace
    gx, gy = trace[-1]
    assert np.hypot(gx - 2.8, gy - (2.0 + 1.6)) < 0.2
