"""RANSAC wall-alignment tests with simulated corner scans."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlolocalisation.config import AlignConfig
from montecarlolocalisation.control import align


def corner_scan(n=360, wall_x=0.5, wall_y=-0.4, noise=0.003, seed=0):
    """Synthetic scan of two perpendicular walls: x = wall_x (ahead) and
    y = wall_y (right side), in the robot frame."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    ranges = np.full(n, np.inf)
    for i, a in enumerate(angles):
        c, s = math.cos(a), math.sin(a)
        cands = []
        if c > 1e-6:
            t = wall_x / c
            if t > 0:
                cands.append(t)
        if s < -1e-6:
            t = wall_y / s
            if t > 0:
                cands.append(t)
        if cands:
            ranges[i] = min(cands)
    valid = np.isfinite(ranges) & (ranges < 3.0)
    ranges = ranges + rng.normal(0, noise, n)
    return (jnp.asarray(ranges[valid], jnp.float32),
            jnp.asarray(angles[valid], jnp.float32))


def test_ransac_finds_two_perpendicular_walls():
    r, a = corner_scan()
    px, py, mask = align.polar_to_cartesian(r, a)
    lines = align.ransac_extract(jax.random.PRNGKey(0), px, py,
                                 np.asarray(mask))
    assert len(lines) == 2
    # getLineAngleDeg uses plain atan: near-perpendicular lines give +-90
    # (sign from the denominator) — preserved reference behavior.
    ang = align.line_angle_deg(lines[0], lines[1])
    assert abs(abs(ang) - 90.0) < 4.0
    d = sorted([align.distance_to_line(l) for l in lines])
    assert d[0] == pytest.approx(0.4, abs=0.02)
    assert d[1] == pytest.approx(0.5, abs=0.02)


def test_wall_side_classification():
    r, a = corner_scan()
    px, py, mask = align.polar_to_cartesian(r, a)
    lines = align.ransac_extract(jax.random.PRNGKey(0), px, py,
                                 np.asarray(mask))
    sides = {align.classify_wall_side(l) for l in lines}
    # One wall ahead-ish (x=0.5: foot at y~0 -> FRONT or near), one right.
    assert align.WALL_RIGHT_SIDE in sides


def test_corner_detection():
    r, a = corner_scan()
    px, py, mask = align.polar_to_cartesian(r, a)
    lines = align.ransac_extract(jax.random.PRNGKey(0), px, py,
                                 np.asarray(mask))
    p = align.intersect_lines(lines[0], lines[1])
    assert p is not None
    # True corner at (0.5, -0.4).
    assert p[0] == pytest.approx(0.5, abs=0.03)
    assert p[1] == pytest.approx(-0.4, abs=0.03)
    assert align.is_corner(lines[0], lines[1])


def test_align_plan_standoff():
    r, a = corner_scan()
    px, py, mask = align.polar_to_cartesian(r, a)
    lines = align.ransac_extract(jax.random.PRNGKey(0), px, py,
                                 np.asarray(mask))
    plan = align.align_plan(lines[0], lines[1])
    kinds = [act.kind for act in plan]
    # rotate? drive rotate drive (faceWall may skip when already aligned).
    assert kinds[-3:] == ["drive", "rotate", "drive"]
    rot = [act for act in plan if act.kind == "rotate"]
    assert abs(rot[-1].value) == pytest.approx(90.0)
    # driveFromWall distance bookkeeping: d - 0.40 + 0.1 / + 0.08.
    drives = [act for act in plan if act.kind == "drive"]
    d0 = align.distance_to_line(lines[0])
    assert drives[0].value == pytest.approx(d0 - 0.40 + 0.1, abs=0.02)
    # Closer than 0.40 m -> reverse speed -5 (align_server.cpp:716-722).
    if d0 * 100 < 40:
        assert drives[0].speed == -5.0
    else:
        assert drives[0].speed == 5.0


def test_ransac_no_lines_in_noise():
    rng = np.random.default_rng(3)
    # Uniform scatter: no 50-inlier line at 0.05 tolerance... use few points.
    px = jnp.asarray(rng.uniform(-2, 2, 60), jnp.float32)
    py = jnp.asarray(rng.uniform(-2, 2, 60), jnp.float32)
    mask = np.ones(60, dtype=bool)
    lines = align.ransac_extract(jax.random.PRNGKey(1), px, py, mask,
                                 AlignConfig())
    assert len(lines) == 0  # below min_inliers=50


def test_align_explores_from_open_space():
    """<2 RANSAC lines must NOT abort the service: the reference explores
    (forward at 5/5, avoidObstacle(0.18) when blocked) until two walls
    lock, then aligns (align_server.cpp:779-793).  From the center of an
    open 3x3-cell room every wall is beyond the 1.0 m laser range, so the
    one-shot flow would return an empty plan."""
    import jax as _jax

    from montecarlolocalisation.config import (
        WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP, FilterConfig,
        SensorModelConfig)
    from montecarlolocalisation.maps import from_walls
    from montecarlolocalisation.sim import align_sim

    room = [[[e for e, on in ((WALL_TOP, r == 0), (WALL_BOTTOM, r == 2),
                              (WALL_LEFT, c == 0), (WALL_RIGHT, c == 2))
              if on]
             for c in range(3)] for r in range(3)]
    box = from_walls(room)
    cfg = FilterConfig(sensor=SensorModelConfig(ray_mode="dda"))
    start = (1.2, 1.2, 0.4)      # room center: nearest wall ~1.2 m away
    px, py, mask = align_sim.full_circle_scan(box, jnp.asarray(start),
                                              cfg)
    assert len(align.ransac_extract(jax.random.PRNGKey(0),
                                    jnp.asarray(px), jnp.asarray(py),
                                    mask, AlignConfig())) < 2
    rb, plan = align_sim.run_align(_jax.random.PRNGKey(0), box, cfg, start)
    assert len(plan) == 4, "explore loop failed to lock two walls"
    assert abs(abs(plan[2].value) - 90.0) < 1e-6
    # Ends inside the room, pulled toward the two locked walls' standoff.
    assert 0.0 < float(rb.x) < 2.4 and 0.0 < float(rb.y) < 2.4


def test_render_align_draws_all_marker_layers():
    """viz.render_align is the stand-in for the reference's RViz RANSAC
    markers (ransac_lines / perpenducular_line / intersect_line,
    align_server.cpp:806-810): lines, perpendicular feet, and the corner
    intersection must all land in the frame."""
    import jax as _jax

    from montecarlolocalisation.config import (FilterConfig,
                                                   SensorModelConfig)
    from montecarlolocalisation.maps import from_walls
    from montecarlolocalisation.sim import align_sim
    from montecarlolocalisation.utils import viz

    box = from_walls([[[0, 1, 2, 3]]])
    cfg = FilterConfig(sensor=SensorModelConfig(ray_mode="dda"))
    px, py, mask = align_sim.full_circle_scan(
        box, jnp.asarray((0.3, 0.5, 0.2)), cfg)
    lines = align.ransac_extract(_jax.random.PRNGKey(0), jnp.asarray(px),
                                 jnp.asarray(py), mask, AlignConfig())
    assert len(lines) >= 2
    img = viz.render_align(px, py, mask, lines)
    assert img.ndim == 3 and img.shape[2] == 3
    for color in (viz.C_SCAN, viz.C_INLIER, viz.C_LINE, viz.C_PERP,
                  viz.C_INTERSECT):
        assert (img == np.array(color, np.uint8)).all(-1).any(), color


def test_align_sim_end_to_end_roughly_centers():
    """Full align_call flow through the simulator: scan -> RANSAC ->
    plan -> timed execution.  The reference's standoff corrections were
    tuned on hardware; the faithful port roughly centers the robot in a
    closed cell (within 0.3 m of the center) and always issues the
    4-action two-wall plan with a 90-degree second rotation."""
    import jax as _jax

    from montecarlolocalisation.config import FilterConfig, SensorModelConfig
    from montecarlolocalisation.maps import from_walls
    from montecarlolocalisation.sim import align_sim

    box = from_walls([[[0, 1, 2, 3]]])
    cfg = FilterConfig(sensor=SensorModelConfig(ray_mode="dda"))
    for start in [(0.3, 0.55, 0.3), (0.6, 0.3, -1.0), (0.45, 0.45, 2.0)]:
        rb, plan = align_sim.run_align(_jax.random.PRNGKey(0), box, cfg, start)
        assert len(plan) == 4
        assert abs(abs(plan[2].value) - 90.0) < 1e-6
        d = np.hypot(float(rb.x) - 0.45, float(rb.y) - 0.45)
        assert d < 0.30, f"align from {start} ended {d:.2f} m from center"
