"""Maze symmetry group + alias-aware convergence metrics.

The default 6x6 maze (and most generated perfect mazes) admits nontrivial
isometries: wall layouts invariant under members of D4.  Global
localization can only resolve pose up to this group — a filter locked onto
a symmetric alias has, physically, converged (every future scan is
identical).  The reference never measures this (its convergence evidence is
eyeballed RViz runs, monte_carlo.cpp:1030-1081); here the sweep metrics
report best-over-aliases error so convergence statistics stop depending on
which alias a seed happens to pick.

A group element g acts on world poses as
    (x, y)  -> M @ (x, y) + t
    theta   -> s * theta + dtheta          (s = +1 rotation, -1 reflection)
and on the wall tensor by a cell permutation + direction-channel
permutation.  `maze_symmetries` enumerates the 8 D4 candidates (composites
of horizontal flip, vertical flip, transpose), keeps those that leave the
wall tensor invariant, and returns the pose action as stacked arrays ready
for vmap/jit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Direction channels (config.DIR_*): RIGHT=0, TOP=1, LEFT=2, BOTTOM=3.
_FLIP_H = dict(cell=lambda w: w[:, ::-1], perm=(2, 1, 0, 3),
               M=np.array([[-1., 0.], [0., 1.]]), t=("W", 0.0),
               s=-1.0, dth=np.pi)
_FLIP_V = dict(cell=lambda w: w[::-1, :], perm=(0, 3, 2, 1),
               M=np.array([[1., 0.], [0., -1.]]), t=(0.0, "H"),
               s=-1.0, dth=0.0)
_TRANSPOSE = dict(cell=lambda w: np.swapaxes(w, 0, 1), perm=(3, 2, 1, 0),
                  M=np.array([[0., 1.], [1., 0.]]), t=(0.0, 0.0),
                  s=-1.0, dth=np.pi / 2)


@dataclasses.dataclass(frozen=True)
class SymmetryGroup:
    """Stacked pose actions of the maze's wall-preserving isometries.

    Index 0 is always the identity.  All arrays are concrete numpy —
    bake-able into jitted metrics.
    """

    M: np.ndarray      # [G, 2, 2]
    t: np.ndarray      # [G, 2] world-frame translation (meters)
    s: np.ndarray      # [G] theta sign
    dth: np.ndarray    # [G] theta offset
    names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.M.shape[0]

    def apply(self, pose):
        """pose [..., 3] -> aliased poses [..., G, 3] (jit-friendly)."""
        m = jnp.asarray(self.M, jnp.float32)                  # [G, 2, 2]
        tt = jnp.asarray(self.t, jnp.float32)                 # [G, 2]
        xy2 = jnp.einsum("gij,...j->...gi", m, pose[..., :2],
                         precision=jax.lax.Precision.HIGHEST) + tt
        th = (jnp.asarray(self.s, jnp.float32) * pose[..., None, 2]
              + jnp.asarray(self.dth, jnp.float32))
        th = jnp.arctan2(jnp.sin(th), jnp.cos(th))
        return jnp.concatenate([xy2, th[..., None]], axis=-1)


def _apply_wall(op, walls):
    w = op["cell"](walls)
    return w[..., list(op["perm"])]


def _compose(a, b):
    """b after a (first a, then b) acting on walls and poses.

    Channel permutation: applying a then b gives
        w2[..., d] = B(w1)[..., pb[d]] = B(A(w))[..., pa[pb[d]]]
    (cell ops permute rows/cols only, so they commute with channel
    indexing), hence perm_comp[d] = a.perm[b.perm[d]].
    """
    perm = tuple(a["perm"][b["perm"][d]] for d in range(4))
    return dict(
        cell=lambda w, A=a, B=b: B["cell"](A["cell"](w)),
        perm=perm,
        M=b["M"] @ a["M"],
        t=("compose", a, b),
        s=b["s"] * a["s"],
        dth=b["s"] * a["dth"] + b["dth"],
    )


def _concrete_t(op, W, H):
    t = op["t"]
    if isinstance(t, tuple) and t and t[0] == "compose":
        _, a, b = t
        return b["M"] @ _concrete_t(a, W, H) + _concrete_t(b, W, H)
    return np.array([W if v == "W" else (H if v == "H" else float(v))
                     for v in t])


_IDENTITY = dict(cell=lambda w: w, perm=(0, 1, 2, 3),
                 M=np.eye(2), t=(0.0, 0.0), s=1.0, dth=0.0)


def maze_symmetries(walls, cell_meters: float = 0.8) -> SymmetryGroup:
    """Enumerate D4 elements that leave the wall tensor invariant.

    walls: [R, C, 4] (0/1).  Returns the pose actions in WORLD meters
    (world extent W = C*cell, H = R*cell; y-down row convention as
    maps/grid.cell_center).
    """
    w = np.asarray(walls)
    rows, cols = w.shape[:2]
    W, H = cols * cell_meters, rows * cell_meters

    candidates = [("id", _IDENTITY)]
    h, v, tr = _FLIP_H, _FLIP_V, _TRANSPOSE
    candidates += [
        ("flip_h", h),
        ("flip_v", v),
        ("rot180", _compose(h, v)),
    ]
    if rows == cols:
        candidates += [
            ("transpose", tr),
            ("rot90", _compose(tr, h)),      # transpose then flip_h
            ("rot270", _compose(tr, v)),
            ("anti_transpose", _compose(_compose(h, v), tr)),
        ]

    keep = []
    for name, op in candidates:
        tw = _apply_wall(op, w)
        if tw.shape == w.shape and np.array_equal(tw, w):
            keep.append((name, op))

    names = tuple(n for n, _ in keep)
    return SymmetryGroup(
        M=np.stack([op["M"] for _, op in keep]).astype(np.float32),
        t=np.stack([_concrete_t(op, W, H) for _, op in keep]).astype(
            np.float32),
        s=np.array([op["s"] for _, op in keep], np.float32),
        dth=np.array([op["dth"] for _, op in keep], np.float32),
        names=names,
    )


def mixture_tracking(particles, weights, truth, sym: SymmetryGroup,
                     stray_radius: float = 0.4):
    """Cloud-as-mixture decomposition over the truth's symmetry orbit.

    `alias_errors` scores only the point estimate; this scores the whole
    CLOUD: each particle is assigned to the nearest alias of the truth
    (its mode), particles farther than `stray_radius` from EVERY alias are
    "stray", and each mode is scored by its importance mass and its
    weighted RMS radius about its alias.  A filter that locked onto
    rot180 of the truth then tracks it tightly is physically converged —
    `tracking_rmse_xy` says HOW tightly, independent of which alias the
    seed picked, which is exactly what single-episode assertions need in
    an aliased maze (sweep fractions already handle the which-mode
    statistics).  jit/vmap friendly: all reductions are one-hot sums, no
    gathers over the particle axis.

    particles [..., N, 3], weights [..., N] (any positive scale), truth
    [..., 3].  Returns dict(
      mode_mass      [..., G]  importance mass per alias (strays excluded),
      mode_rmse_xy   [..., G]  weighted RMS xy radius per mode (nan if empty),
      stray_mass     [...]     mass farther than stray_radius from every alias,
      dominant_mode  [...]     argmax-mass alias index (0 = true pose),
      dominant_mass  [...]     its mass,
      tracking_rmse_xy [...]   the dominant mode's RMS radius).
    """
    aliases = sym.apply(jnp.asarray(truth, jnp.float32))      # [..., G, 3]
    p = jnp.asarray(particles, jnp.float32)
    w = jnp.asarray(weights, jnp.float32)
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-30)
    d = p[..., :, None, :2] - aliases[..., None, :, :2]       # [..., N, G, 2]
    dist2 = jnp.sum(d * d, axis=-1)                           # [..., N, G]
    # Assignment tie-break: at a symmetry FIXED POINT (e.g. the maze
    # center under rot180) distinct aliases coincide in xy and a bare
    # argmin would collapse their mass onto the lowest-index alias.  A
    # small wrapped-theta term separates xy-degenerate aliases by pose;
    # the epsilon keeps any real xy gap dominant (<= 1e-3 * pi^2 m^2).
    dth = p[..., :, None, 2] - aliases[..., None, :, 2]       # [..., N, G]
    dth = jnp.arctan2(jnp.sin(dth), jnp.cos(dth))
    gi = jnp.argmin(dist2 + 1e-3 * dth * dth, axis=-1)        # [..., N]
    dmin2 = jnp.take_along_axis(dist2, gi[..., None], axis=-1)[..., 0]
    stray = (dmin2 > stray_radius * stray_radius).astype(jnp.float32)
    onehot = (jax.nn.one_hot(gi, sym.size, dtype=jnp.float32)
              * (1.0 - stray)[..., None])                     # [..., N, G]
    wm = w[..., None] * onehot
    mode_mass = jnp.sum(wm, axis=-2)                          # [..., G]
    mode_m2 = jnp.sum(wm * dmin2[..., None], axis=-2)
    mode_rmse = jnp.where(
        mode_mass > 1e-9,
        jnp.sqrt(mode_m2 / jnp.maximum(mode_mass, 1e-30)), jnp.nan)
    dom = jnp.argmax(mode_mass, axis=-1)
    dom_mass = jnp.take_along_axis(mode_mass, dom[..., None], axis=-1)[..., 0]
    dom_rmse = jnp.take_along_axis(mode_rmse, dom[..., None], axis=-1)[..., 0]
    return dict(mode_mass=mode_mass, mode_rmse_xy=mode_rmse,
                stray_mass=jnp.sum(w * stray, axis=-1),
                dominant_mode=dom, dominant_mass=dom_mass,
                tracking_rmse_xy=dom_rmse)


def alias_errors(best_pose, truth, sym: SymmetryGroup):
    """Best-over-aliases pose errors (jit/vmap friendly).

    best_pose [..., 3] (may carry the (-1,-1,-1) sentinel), truth [..., 3].
    Returns dict(err_xy, err_theta, alias_idx): the xy error minimized over
    the truth's orbit under `sym`, the heading error of THAT alias, and
    which alias won (0 = true pose).
    """
    aliases = sym.apply(jnp.asarray(truth, jnp.float32))      # [..., G, 3]
    bp = jnp.asarray(best_pose, jnp.float32)[..., None, :]
    d = bp[..., :2] - aliases[..., :2]
    err = jnp.sqrt(jnp.sum(d * d, axis=-1))                   # [..., G]
    gi = jnp.argmin(err, axis=-1)                             # [...]
    err_xy = jnp.take_along_axis(err, gi[..., None], axis=-1)[..., 0]
    dth = bp[..., 2] - aliases[..., 2]
    dth = jnp.arctan2(jnp.sin(dth), jnp.cos(dth))
    err_th = jnp.take_along_axis(
        jnp.abs(dth), gi[..., None], axis=-1)[..., 0]
    return dict(err_xy=err_xy, err_theta=err_th, alias_idx=gi)
