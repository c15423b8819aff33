"""Occupancy-grid mapping from scans: learn the map the filter localizes in.

No reference counterpart — the reference REQUIRES a hand-written map.txt
(publish_map.py); its stack cannot produce a map from sensor data.  This
module closes that loop: drive (wanderer), record scans, build the
occupancy grid, then localize/plan on the LEARNED map
(maps/grid.from_raster + synthesize_walls give the planner-ready wall
tensor).  Mapping + the existing filter = the full explore -> map ->
localize -> plan autonomy loop.

Design.  The classical implementation walks each beam with Bresenham and
scatters log-odds updates into cells — a data-dependent scatter with
write conflicts.  Here the update is turned inside out into a DENSE
inverse sensor model: for every (pixel, beam) pair, closed-form ray
geometry (longitudinal projection + perpendicular distance) classifies the
pixel as free-space (crossed by the beam short of its return), hit (the
wall pixel body just past the return), or untouched; summing over beams
gives the per-pixel log-odds delta.  [H, W, B] broadcast compute, zero
scatter/gather, one fused XLA kernel per tick — at the reference's map
size (49 x 49 x 34 beams) a tick costs ~3M flops, so full episodes run
under `lax.scan` and fleets of mappers under `vmap`.

Sensor geometry matches the filter exactly (models/sensor.expected_ranges):
ray origin `laser_offset` ahead of the pose along its heading
(monte_carlo.cpp:643-645), beam angle negated when cfg.negate_beam_angle
(:653).  Hit evidence is deposited on [r, r + res] along the ray — the
casters return the distance to the occupied pixel's NEAR face, so the
pixel body lies one resolution beyond the return.

Log-odds fusion: evidence adds, so maps from independent robots/episodes
fuse by summation (`fuse_maps`), and a map is checkpointable as a plain
array.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MappingConfig, SensorModelConfig


def init_map(cfg: MappingConfig):
    """Uniform-prior log-odds grid [H, W] (0 = unknown)."""
    return jnp.zeros((cfg.height, cfg.width), jnp.float32)


def sensor_window_px(cfg: MappingConfig) -> int:
    """Static window side (pixels) covering one scan's full reach.

    A scan touches pixels whose centers lie within max_trusted_range +
    hit_depth (along-ray) + half_width (across-ray) of the ray origin;
    +1 px absorbs the origin's sub-pixel offset.  Odd side, origin pixel
    centered."""
    reach = cfg.max_trusted_range + cfg.hit_depth + cfg.half_width
    return 2 * (int(math.ceil(reach / cfg.resolution)) + 1) + 1


def _ism_delta(window, rows, cols, ox, oy, ray, ranges, valid, returned,
               cfg: MappingConfig):
    """Inverse-sensor-model log-odds update of `window` [h, w] whose pixel
    (i, j) sits at raster row rows[i], col cols[j].  The dense [h, w, B]
    classification: closed-form ray geometry per (pixel, beam), zero
    scatter (module docstring)."""
    res = cfg.resolution
    cb = jnp.cos(ray)
    sb = jnp.sin(ray)
    # Pixel-center world coords (identical arithmetic to the full-grid
    # form: origin + (index + 0.5) * res — windowed runs are bit-exact).
    pxx = cfg.origin_x + (cols.astype(jnp.float32) + 0.5) * res
    pxy = cfg.origin_y + (rows.astype(jnp.float32) + 0.5) * res
    dxp = (pxx[None, :] - ox)[..., None]              # [1, w, 1]
    dyp = (pxy[:, None] - oy)[..., None]              # [h, 1, 1]

    proj = dxp * cb + dyp * sb                        # [h, w, B]
    perp = jnp.abs(dyp * cb - dxp * sb)

    on_ray = (perp <= cfg.half_width).astype(jnp.float32) * valid
    free = on_ray * ((proj >= 0.0)
                     & (proj < ranges - cfg.hit_margin)).astype(jnp.float32)
    # The wall pixel CENTER sits ~res/2 past the near-face return, so the
    # hit window is [r - hit_margin, r + hit_depth] with hit_depth ~
    # 0.7*res: deep enough to cover the wall pixel center under range
    # noise, shallow enough that oblique rays — whose along-ray window
    # drifts LATERALLY behind thin walls — do not paint the open pixel
    # diagonally behind the wall (measured: a full-res far side painted
    # phantom walls on corridor bands next to corners).
    hit = on_ray * returned * (
        (proj >= ranges - cfg.hit_margin)
        & (proj <= ranges + cfg.hit_depth)).astype(jnp.float32)

    delta = cfg.l_occ * jnp.sum(hit, axis=-1) - cfg.l_free * jnp.sum(
        free, axis=-1)
    return jnp.clip(window + delta, -cfg.clamp, cfg.clamp)


def update_map(logodds, pose, ranges, angles, mask, cfg: MappingConfig,
               sensor_cfg: SensorModelConfig):
    """One scan's dense inverse-sensor-model update.  jit/scan/vmap-safe.

    pose [3] world (x, y, theta); ranges/angles/mask [B].  Beams whose
    return is at/right of max_range carve free space but deposit no hit
    (no-return); masked-out beams contribute nothing.

    Cost is windowed to the SENSOR's reach, not the map area: on maps
    larger than `sensor_window_px` the [h, w, B] classification runs on a
    `dynamic_slice` window around the ray origin (clamped at borders, so
    it always covers the in-map reach) and is written back with
    `dynamic_update_slice` — per-tick cost stays ~constant as maps grow
    (a 1 m sensor touches <2% of a 25 m map).  Bit-exact with the
    full-grid path: pixels outside the window get delta 0 and clip is an
    identity on already-clamped values.
    """
    res = cfg.resolution
    x, y, theta = pose[0], pose[1], pose[2]
    ox = x + sensor_cfg.laser_offset * jnp.cos(theta)
    oy = y + sensor_cfg.laser_offset * jnp.sin(theta)
    sign = -1.0 if sensor_cfg.negate_beam_angle else 1.0
    ray = theta + sign * angles                       # [B]

    r = jnp.asarray(ranges, jnp.float32)
    valid = jnp.asarray(mask, jnp.float32) * (
        r <= cfg.max_trusted_range).astype(jnp.float32)
    returned = (r < sensor_cfg.max_range - 1e-6).astype(jnp.float32)

    h, w = logodds.shape[-2], logodds.shape[-1]
    s = sensor_window_px(cfg)
    if 2 * s > min(h, w):
        # Small maps (window > half the side): the dense classification
        # is cheaper than the dynamic_slice round trip — and the default
        # 49 px maze keeps its original single-fusion program.
        return _ism_delta(logodds, jnp.arange(h), jnp.arange(w),
                          ox, oy, ray, r, valid, returned, cfg)
    sh, sw = min(s, h), min(s, w)
    ri = jnp.floor((oy - cfg.origin_y) / res).astype(jnp.int32)
    ci = jnp.floor((ox - cfg.origin_x) / res).astype(jnp.int32)
    r0 = jnp.clip(ri - sh // 2, 0, h - sh)
    c0 = jnp.clip(ci - sw // 2, 0, w - sw)
    win = jax.lax.dynamic_slice(logodds, (r0, c0), (sh, sw))
    new = _ism_delta(win, r0 + jnp.arange(sh), c0 + jnp.arange(sw),
                     ox, oy, ray, r, valid, returned, cfg)
    return jax.lax.dynamic_update_slice(logodds, new, (r0, c0))


def map_episode(poses, scan_ranges, scan_angles, cfg: MappingConfig,
                sensor_cfg: SensorModelConfig, scan_mask=None,
                logodds=None):
    """Fold a whole episode's scans into one map with `lax.scan`.

    poses [T, 3] (ground-truth or filter-estimated), scan_ranges [T, B],
    scan_angles [B] static beam table, scan_mask [T, B] optional.  vmap
    over a leading episode axis for parallel mappers (fuse with
    `fuse_maps`).
    """
    angles = jnp.asarray(scan_angles, jnp.float32)
    ranges = jnp.asarray(scan_ranges, jnp.float32)
    if scan_mask is None:
        scan_mask = jnp.ones(ranges.shape, jnp.float32)
    if logodds is None:
        logodds = init_map(cfg)

    def body(lo, xs):
        pose, rng, msk = xs
        return update_map(lo, pose, rng, angles, msk, cfg, sensor_cfg), None

    lo, _ = jax.lax.scan(
        body, logodds,
        (jnp.asarray(poses, jnp.float32), ranges,
         jnp.asarray(scan_mask, jnp.float32)))
    return lo


def dead_reckon_poses(encoders, start_pose, motion_cfg):
    """Cumulative encoder radians [T, 2] -> dead-reckoned poses [T, 3].

    The realistic mapping input when no ground truth exists: integrate
    the encoder log through the reference's midpoint diff-drive model
    (models/motion.diff_drive_update) from a known start pose.  Row t is
    the pose AFTER tick t, aligned with the simulator's truth rows.
    """
    from . import motion

    sp = jnp.asarray(start_pose, jnp.float32)
    state0 = motion.OdometryState(
        x=sp[0], y=sp[1], theta=sp[2],
        encoder_left=jnp.float32(0.0), encoder_right=jnp.float32(0.0))

    def body(st, enc):
        new, _, _, _ = motion.diff_drive_update(st, enc[0], enc[1],
                                                motion_cfg)
        return new, jnp.stack([new.x, new.y, new.theta])

    _, poses = jax.lax.scan(body, state0,
                            jnp.asarray(encoders, jnp.float32))
    return poses


def fuse_maps(logodds_stack):
    """Fuse maps from independent robots/episodes: log-odds evidence adds."""
    return jnp.sum(logodds_stack, axis=0)


def to_occupancy(logodds, threshold: float = 0.0):
    """Log-odds -> boolean occupancy raster (True = wall)."""
    return logodds > threshold


def to_trinary(logodds, occ_threshold: float = 0.5,
               free_threshold: float = -0.5):
    """Log-odds -> map_server trinary int8: 100 occupied, 0 free,
    -1 unknown (in-between evidence).  Feed to maps/pgm.export_raster to
    publish a LEARNED map in ROS map_server format."""
    lo = np.asarray(logodds)
    return np.where(lo > occ_threshold, 100,
                    np.where(lo < free_threshold, 0, -1)).astype(np.int8)


def export_learned_map(logodds, cfg: MappingConfig, pgm_path: str,
                       yaml_path=None) -> None:
    """Write a learned map as a ROS map_server PGM (+YAML) trinary."""
    from ..maps import pgm

    pgm.export_raster(to_trinary(logodds), cfg.resolution, cfg.origin_x,
                      cfg.origin_y, pgm_path, yaml_path)


def fit_walls(logodds, cell_px: int = 8, explored_abs: float = 0.5,
              min_explored_frac: float = 0.4,
              unexplored_is_wall: bool = True,
              return_explored: bool = False,
              offset_tol: int = 2) -> np.ndarray:
    """Snap a learned map onto the reference's cell lattice -> [R, C, 4].

    For each lattice edge, pools the log-odds over the edge's OPEN band
    (its pixels excluding the two shared corner pixels — the same band
    maps/grid.synthesize_walls uses).  Pixels with |log-odds| <=
    `explored_abs` are UNOBSERVED; a band observed on at least
    `min_explored_frac` of its pixels is decided by the SIGN of its summed
    evidence, an unobserved band falls back to `unexplored_is_wall`
    (default True — synthesize_walls' conservative planner semantics:
    never route through unknown space).  Pooling makes the decision
    robust to per-pixel speckle of a partially explored map.  (Host-side
    NumPy: this is an offline analysis/export step, not filter-path code.)

    `return_explored=True` additionally returns the [R, C, 4] bool mask of
    edges whose band WAS observed — partial explorations can then be scored
    over evidence only (`wall_metrics(..., mask=explored)`), separating map
    QUALITY from map COVERAGE (the planner-conservative default turns every
    unexplored edge into a wall, which reads as a false positive).

    `offset_tol` makes the vote robust to the SMOOTH part of SLAM/odometry
    drift: when the lattice band itself does not vote wall, the edge is
    also evaluated shifted ±k px perpendicular to its line
    (k <= offset_tol) and flips to WALL when a shifted band is
    well-observed AND nearly pure positive evidence (purity >= 0.8 of
    total |log-odds| mass) — the signature of a wall deposited a pixel
    or two off its line by 0.1-0.2 m of pose drift (free-space carving
    cannot cross a wall, so a displaced wall's band saturates positive,
    while the grazing-incidence phantom paint found next to corners
    rides mixed-sign bands and the purity is fusion-scale-invariant).
    Walls are 1 px thin and parallel structure is cell_px (8) px away,
    so ±2 px shifts cannot read a NEIGHBORING edge's wall.  The default
    2 was chip-swept on 2x16 SLAM episodes (3% slip, T=2000): explored
    -edge F1 0.813/0.823 at tol 1 -> 0.851/0.859 at tol 2 with NO
    trajectory change, and clean-pose (non-drifted) maps are inert to
    it (the purity gate blocks flips off true free interiors).
    offset_tol=0 restores the strict lattice vote.
    """
    lo = np.asarray(logodds)
    h, w = lo.shape
    # The no-neighbor-crosstalk argument above holds only while shifted
    # bands stay strictly inside the cell interior: with small cell_px a
    # wall drifted off the NEIGHBORING lattice line would land inside this
    # line's shifted band with pure positive evidence and flip a phantom
    # wall.  Clamp the effective tolerance (cell_px=8 keeps the default 2).
    offset_tol = min(offset_tol, max((cell_px - 1) // 2 - 1, 0))
    n_rows = max(1, (h - 1) // cell_px)
    n_cols = max(1, (w - 1) // cell_px)
    walls = np.zeros((n_rows, n_cols, 4), dtype=bool)
    seen = np.zeros((n_rows, n_cols, 4), dtype=bool)

    def band_sum(rr0, rr1, cc0, cc1):
        """(net evidence, explored frac, evidence purity) of one band;
        None off-grid.  Purity = net / total |evidence| — a genuinely
        displaced wall band is almost ALL positive (free-space carving
        cannot cross the wall), while grazing-incidence phantom paint
        next to corners rides on mixed-sign bands, and the ratio is
        invariant to how many episodes were fused into the map."""
        if rr0 < 0 or cc0 < 0 or rr0 >= h or cc0 >= w or rr1 > h \
                or cc1 > w:
            return None
        band = lo[rr0:rr1, cc0:cc1]
        if band.size == 0:
            return None
        explored = np.abs(band) > explored_abs
        net = float(np.sum(band[explored]))
        tot = float(np.sum(np.abs(band[explored])))
        return net, float(np.mean(explored)), net / max(tot, 1e-9)

    def band_vote(r0, r1, c0, c1, drow, dcol):
        if r0 >= h or c0 >= w or r1 > h or c1 > w:
            # Off-raster edges are walls (synthesize_walls rule).
            return True, False
        base = band_sum(r0, r1, c0, c1)
        base_ok = base is not None and base[1] >= min_explored_frac
        # The lattice band itself decides by evidence SIGN (the strict
        # vote).  A drift-shifted band may only FLIP the decision to
        # wall on strong, well-observed positive mass — phantom corner
        # paint on a sparse off-line band must not invent walls.
        wall = base_ok and base[0] > 0.0
        seen_any = base_ok
        if not wall:
            for k in range(-offset_tol, offset_tol + 1):
                if k == 0:
                    continue
                s = band_sum(r0 + k * drow, r1 + k * drow,
                             c0 + k * dcol, c1 + k * dcol)
                if s is None or s[1] < max(min_explored_frac, 0.6):
                    continue
                seen_any = True
                if s[2] >= 0.8 and s[0] >= 5.0 * explored_abs:
                    wall = True
                    break
        if not seen_any:
            return unexplored_is_wall, False
        return wall, True

    from ..config import WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM

    for r in range(n_rows):
        for c in range(n_cols):
            r0, c0 = r * cell_px, c * cell_px
            for edge, (rr0, rr1, cc0, cc1, drow, dcol) in (
                (WALL_TOP, (r0, r0 + 1, c0 + 1, c0 + cell_px, 1, 0)),
                (WALL_BOTTOM, (r0 + cell_px, r0 + cell_px + 1,
                               c0 + 1, c0 + cell_px, 1, 0)),
                (WALL_LEFT, (r0 + 1, r0 + cell_px, c0, c0 + 1, 0, 1)),
                (WALL_RIGHT, (r0 + 1, r0 + cell_px,
                              c0 + cell_px, c0 + cell_px + 1, 0, 1)),
            ):
                walls[r, c, edge], seen[r, c, edge] = band_vote(
                    rr0, rr1, cc0, cc1, drow, dcol)
    if return_explored:
        return walls, seen
    return walls


def wall_metrics(learned: np.ndarray, truth: np.ndarray,
                 mask: np.ndarray = None) -> dict:
    """Precision/recall/F1 of a learned wall tensor against the truth.

    `mask` restricts scoring to edges where it is True (e.g. fit_walls'
    explored mask — map quality over evidence, excluding the
    planner-conservative unexplored=wall default).
    """
    learned = np.asarray(learned, bool)
    truth = np.asarray(truth, bool)
    if mask is not None:
        mask = np.asarray(mask, bool)
        learned, truth = learned[mask], truth[mask]
    tp = float(np.sum(learned & truth))
    fp = float(np.sum(learned & ~truth))
    fn = float(np.sum(~learned & truth))
    prec = tp / max(tp + fp, 1.0)
    rec = tp / max(tp + fn, 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return dict(precision=prec, recall=rec, f1=f1)
