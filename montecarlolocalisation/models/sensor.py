"""Beam sensor model: scan filtering, likelihood, and scan simulation.

Reference behavior reproduced:
  * filterLaserReadings (monte_carlo.cpp:254-278): NaN/Inf beams become
    radius 1.05 with their nominal angle; finite beams inside
    [range_min, range_max] are kept; finite out-of-range beams are DROPPED
    (which shifts downstream indices — handled host-side).
  * filterAngles (monte_carlo.cpp:610-620): keep beams with angle strictly
    inside (-120, +120) degrees.
  * computeWeight (monte_carlo.cpp:623-682): every `beam_skip`-th filtered
    beam; ray origin offset `laser_offset` along the heading; beam angle
    NEGATED; per-beam prob = w_hit * TruncGauss(|obs - exp|; sigma)
    + w_rand * 1[|obs - max_range| < 0.01]; probs SUMMED over beams (not
    multiplied); particles failing isValidPos keep weight 0.

In-graph beams are fixed-size arrays (angles [B], ranges [B], mask [B]) so a
whole episode jit-compiles with static shapes; `filter_scan` is the host-side
preprocessor that converts a raw (ragged) LaserScan into that form.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, is_valid_pos
from .raycast import raycast


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scan:
    """Fixed-size filtered scan: the observation fed to the filter step."""

    angles: jax.Array  # [B] beam angles (radians, LIDAR frame, pre-negation)
    ranges: jax.Array  # [B] observed radii (m)
    mask: jax.Array    # [B] bool — False lanes contribute nothing


def filter_scan(
    ranges: np.ndarray,
    angle_min: float,
    angle_increment: float,
    range_min: float,
    range_max: float,
    cfg: SensorModelConfig = SensorModelConfig(),
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side reproduction of filterLaserReadings + filterAngles + skip.

    Returns (angles [B], ranges [B], mask [B]) numpy arrays, optionally
    padded to `pad_to` lanes.
    """
    ranges = np.asarray(ranges, dtype=np.float64)
    idx = np.arange(len(ranges))
    angles = angle_min + idx * angle_increment
    bad = ~np.isfinite(ranges)
    keep = bad | ((ranges >= range_min) & (ranges <= range_max))
    radii = np.where(bad, cfg.invalid_beam_range, ranges)[keep]
    angles = angles[keep]
    # Angular crop, strict inequalities (monte_carlo.cpp:615).
    deg = angles * 180.0 / math.pi
    crop = (deg > -cfg.angle_crop_deg) & (deg < cfg.angle_crop_deg)
    radii, angles = radii[crop], angles[crop]
    # Every beam_skip-th beam (monte_carlo.cpp:650).
    radii = radii[:: cfg.beam_skip]
    angles = angles[:: cfg.beam_skip]
    mask = np.ones(len(radii), dtype=bool)
    if pad_to is not None:
        pad = pad_to - len(radii)
        if pad < 0:
            raise ValueError(f"pad_to={pad_to} < {len(radii)} beams")
        radii = np.pad(radii, (0, pad))
        angles = np.pad(angles, (0, pad))
        mask = np.pad(mask, (0, pad))
    return (
        angles.astype(np.float32),
        radii.astype(np.float32),
        mask,
    )


def default_beam_angles(
    cfg: SensorModelConfig = SensorModelConfig(),
    angle_min_deg: float = -135.0,
    angle_increment_deg: float = 0.352,
    n_raw_beams: int = 726,
) -> np.ndarray:
    """Nominal beam table of the reference LIDAR (monte_carlo.cpp:637-639:
    0.352 deg/beam, angle_min -135 deg), filtered+subsampled."""
    angles = (angle_min_deg + np.arange(n_raw_beams) * angle_increment_deg)
    angles = angles[(angles > -cfg.angle_crop_deg) & (angles < cfg.angle_crop_deg)]
    angles = angles[:: cfg.beam_skip]
    return np.deg2rad(angles).astype(np.float32)


def make_scan(angles, ranges, mask=None) -> Scan:
    angles = jnp.asarray(angles, jnp.float32)
    ranges = jnp.asarray(ranges, jnp.float32)
    if mask is None:
        mask = jnp.ones(angles.shape, dtype=bool)
    return Scan(angles=angles, ranges=jnp.broadcast_to(ranges, angles.shape),
                mask=jnp.asarray(mask))


def gauss_pdf(diff, cfg: SensorModelConfig):
    """Truncated N(0, sigma) pdf: zero outside [0, gauss_max_diff]
    (GaussianLookup, monte_carlo.cpp:139-177).  Computed exactly; the
    reference LUT (1e-4 resolution, lerp) agrees to ~1e-9."""
    denom = cfg.sigma * math.sqrt(2.0 * math.pi)
    pdf = jnp.exp(-(diff * diff) / (2.0 * cfg.sigma * cfg.sigma)) / denom
    return jnp.where((diff >= 0.0) & (diff <= cfg.gauss_max_diff), pdf, 0.0)


def expected_ranges(m: MazeMap, poses, scan_angles, cfg: SensorModelConfig):
    """Raycast expected distances for poses [..., 3] x beams [B] -> [..., B].

    Ray origin is laser_offset ahead of the pose along its heading
    (monte_carlo.cpp:643-645); the beam angle is negated when
    cfg.negate_beam_angle (monte_carlo.cpp:653: angle = -(beam.angle)).
    """
    x, y, theta = poses[..., 0], poses[..., 1], poses[..., 2]
    ox = x + cfg.laser_offset * jnp.cos(theta)
    oy = y + cfg.laser_offset * jnp.sin(theta)
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray_angle = theta[..., None] + sign * scan_angles
    return raycast(m, ox[..., None], oy[..., None], ray_angle, cfg)


def resolve_lookup_mode(m: MazeMap, particles, cfg: SensorModelConfig,
                        valid_offset: float = 0.1,
                        platform: Optional[str] = None) -> str:
    """The beam-weight implementation for one call, chosen in one place.

    "auto" takes the fused kernel (ops/weights_pallas) on the GPU wherever
    it computes exactly what was asked (weights_pallas.supports), and the
    XLA "gather" path everywhere else.  "pallas" demands the kernel and
    raises where it cannot run; "bits" on a traced map becomes "onehot".
    """
    from ..ops import weights_pallas
    from ..ops.bitlookup import is_concrete_map

    platform = platform or jax.default_backend()
    mode = cfg.lookup_mode
    kernel_ok = weights_pallas.supports(m, particles, cfg, valid_offset)
    if mode == "auto":
        mode = "pallas" if platform == "gpu" and kernel_ok else "gather"
    if mode == "pallas" and not (platform == "gpu" and kernel_ok):
        raise ValueError(
            "lookup_mode='pallas' needs a GPU and a config the fused "
            f"kernel supports (platform={platform!r}, "
            f"ray_mode={cfg.ray_mode!r}, beam_combine={cfg.beam_combine!r}, "
            f"quantize_ray_deg={cfg.quantize_ray_deg})")
    if mode == "bits" and not is_concrete_map(m):
        mode = "onehot"
    return mode


def beam_weights(m: MazeMap, particles, scan: Scan, cfg: SensorModelConfig,
                 valid_offset: float = 0.1):
    """computeWeight: unnormalized weights [N] for particles [N, 3].

    (monte_carlo.cpp:623-682).  Invalid positions get exactly 0.
    The implementation comes from resolve_lookup_mode.
    """
    mode = resolve_lookup_mode(m, particles, cfg, valid_offset)
    if mode == "pallas":
        return beam_weights_fused(m, particles, scan, cfg)
    return _beam_weights_dense(m, particles, scan, cfg, valid_offset, mode)


def _valid_pos_bits(m, px, py):
    """isValidPos via the dilated bit raster (offset == one pixel)."""
    from ..maps.grid import is_inside_map
    from ..ops.bitlookup import MapBitTables

    _, dil_lookup = MapBitTables.get(m)
    mx = ((px - m.origin_x) / m.resolution).astype(jnp.int32)
    my = ((py - m.origin_y) / m.resolution).astype(jnp.int32)
    return is_inside_map(m, px, py) & ~dil_lookup(my, mx)


def _beam_weights_dense(m, particles, scan, cfg, valid_offset, mode):
    """The XLA implementation (gather / onehot / bits lookups)."""
    expected = expected_ranges(m, particles, scan.angles, cfg)  # [N, B]
    observed = scan.ranges  # [B]
    diff = jnp.abs(observed - expected)
    p_hit = cfg.w_hit * gauss_pdf(diff, cfg)
    p_rand = cfg.w_rand * (
        jnp.abs(observed - cfg.max_range) < cfg.rand_window
    ).astype(jnp.float32)
    per_beam = p_hit + p_rand
    if cfg.beam_combine == "log":
        # Product of per-beam likelihoods (summed logs), floored so one
        # zero beam doesn't erase the particle.  Shift by the global max
        # log-weight before exponentiating: at 34+ beams the raw product
        # underflows f32 (relative weights are all resampling needs).
        logs = jnp.sum(jnp.log(jnp.maximum(per_beam, 1e-6)) * scan.mask,
                       axis=-1) / cfg.log_temperature
        prob = jnp.exp(logs - jnp.max(logs))
    else:
        prob = jnp.sum(per_beam * scan.mask, axis=-1)
    px, py = particles[..., 0], particles[..., 1]
    if mode == "bits" and abs(valid_offset - m.resolution) < 1e-9:
        valid = _valid_pos_bits(m, px, py)
    elif mode == "onehot" and abs(valid_offset - m.resolution) < 1e-9:
        from ..ops.lookup import is_valid_pos_onehot

        valid = is_valid_pos_onehot(m, px, py)
    else:
        valid = is_valid_pos(m, px, py, valid_offset)
    return jnp.where(valid, prob, 0.0)


def beam_weights_partial(m: MazeMap, known: MazeMap, particles, scan: Scan,
                         cfg: SensorModelConfig, valid_offset: float = 0.1):
    """computeWeight on a PARTIAL (learned) map: unknown-aware scoring.

    `m` is the conservative learned maze (evidenced walls + unexplored
    edges closed, mapping.fit_walls' unexplored_is_wall=True — the raster
    the planner and particle-validity already use), `known` the SAME fit
    with unexplored edges OPEN (walls only where evidence says wall, so
    walls(known) ⊆ walls(m) and d_known >= d_cons per beam).

    Casting each beam on both rasters classifies it exactly: where the
    two distances agree the beam lives entirely in mapped space and is
    scored by the standard reference model against the evidenced wall
    (gauss_pdf on |z - d_known|, monte_carlo.cpp:623-682 semantics);
    where d_cons < d_known the beam crosses the exploration frontier at
    d_cons before reaching any evidenced wall, and a measurement at or
    beyond that frontier says nothing the map can check — it gets the
    flat cfg.unknown_credit fraction of the peak hit probability instead
    of being punished against a phantom wall.  A measurement SHORT of the
    frontier is a claim about mapped free space and keeps the standard
    (punishing) score.  Net effect: relocalization quality degrades with
    map coverage instead of cliffing — the phantom walls of a 50%-explored
    map no longer contradict every beam that looks outward.

    Validity/injection semantics are unchanged (conservative map): the
    filter only ever PLACES particles in explored space; this scorer only
    stops mis-SCORING them for looking toward unexplored space.
    """
    d_cons = expected_ranges(m, particles, scan.angles, cfg)      # [N, B]
    d_known = expected_ranges(known, particles, scan.angles, cfg)
    observed = scan.ranges                                        # [B]
    frontier = d_cons < d_known - 1e-4
    beyond = observed >= d_cons - cfg.sigma
    peak = 1.0 / (cfg.sigma * math.sqrt(2.0 * math.pi))
    p_hit = cfg.w_hit * gauss_pdf(jnp.abs(observed - d_known), cfg)
    if cfg.unknown_credit_mode == "interval":
        # Frontier-distance-aware credit: the marginal density of z under
        # "a wall sits uniformly in the unknown stretch beyond the
        # frontier" — 1 / |unknown interval|, capped at the Gaussian peak
        # (a beam cannot be MORE informative than a mapped wall).  Beams
        # grazing the frontier keep near-mapped-beam strength; beams deep
        # into unknown space decay toward zero credit, so the cloud is
        # not uniformly subsidized for looking outward.
        interval = jnp.maximum(cfg.max_range - d_cons, 0.0) + cfg.sigma
        credit = cfg.w_hit * jnp.minimum(1.0 / interval, peak)
    else:
        credit = jnp.float32(cfg.unknown_credit * cfg.w_hit * peak)
    p_hit = jnp.where(frontier & beyond, credit, p_hit)
    p_rand = cfg.w_rand * (
        jnp.abs(observed - cfg.max_range) < cfg.rand_window
    ).astype(jnp.float32)
    per_beam = p_hit + p_rand
    if cfg.beam_combine == "log":
        logs = jnp.sum(jnp.log(jnp.maximum(per_beam, 1e-6)) * scan.mask,
                       axis=-1) / cfg.log_temperature
        prob = jnp.exp(logs - jnp.max(logs))
    else:
        prob = jnp.sum(per_beam * scan.mask, axis=-1)
    px, py = particles[..., 0], particles[..., 1]
    from ..ops.bitlookup import is_concrete_map

    if is_concrete_map(m) and abs(valid_offset - m.resolution) < 1e-9:
        valid = _valid_pos_bits(m, px, py)
    else:
        valid = is_valid_pos(m, px, py, valid_offset)
    return jnp.where(valid, prob, 0.0)


def finish_log_weights(m, cfg, particles, raw_logs, axis=None):
    """Log-combine epilogue: temperature, max-log shift, validity gate.

    The fused kernel emits RAW per-particle log-sums (a per-block kernel
    cannot see the max); this finishes them exactly as the dense path does
    (_beam_weights_dense).  axis=None takes the global max (single
    filter); an int axis takes per-episode maxes for batched launches.
    """
    logs = raw_logs / cfg.log_temperature
    prob = jnp.exp(logs - jnp.max(logs, axis=axis,
                                  keepdims=axis is not None))
    return jnp.where(
        _valid_pos_bits(m, particles[..., 0], particles[..., 1]), prob, 0.0)


def beam_weights_fused(m: MazeMap, particles, scan: Scan,
                       cfg: SensorModelConfig, interpret: bool = False):
    """The fused kernel as a drop-in for beam_weights (offset == one
    pixel).  vmap over episodes folds into the kernel's episode grid axis
    (any depth of nesting); a per-episode beam table takes the dense path.
    `interpret=True` runs the Pallas interpreter (tests only)."""
    from ..ops.weights_pallas import beam_weights_kernel

    valid_offset = float(m.resolution)

    @jax.custom_batching.custom_vmap
    def fn(p, angles, ranges, mask):        # [E, N, 3], [B], [E, B], [E, B]
        out = beam_weights_kernel(m, p, angles, ranges, mask, cfg,
                                  interpret=interpret)
        if cfg.beam_combine == "log":
            out = finish_log_weights(m, cfg, p, out, axis=1)
        return out

    @fn.def_vmap
    def _rule(axis_size, in_batched, p, angles, ranges, mask):
        p_b, a_b, r_b, m_b = in_batched
        if a_b:
            def dense(pp, aa, rr, mm):
                return jax.vmap(lambda p1, r1, m1: _beam_weights_dense(
                    m, p1, Scan(angles=aa, ranges=r1, mask=m1 > 0), cfg,
                    valid_offset, "gather"))(pp, rr, mm)

            in_axes = [0 if b else None for b in in_batched]
            return jax.vmap(dense, in_axes=in_axes)(
                p, angles, ranges, mask), True
        lift = lambda a, b: a if b else jnp.broadcast_to(
            a, (axis_size,) + a.shape)
        p, ranges, mask = lift(p, p_b), lift(ranges, r_b), lift(mask, m_b)
        n_ep, n = p.shape[1], p.shape[2]
        out = fn(p.reshape(axis_size * n_ep, n, 3), angles,
                 ranges.reshape(axis_size * n_ep, -1),
                 mask.reshape(axis_size * n_ep, -1))
        return out.reshape(axis_size, n_ep, n), True

    angles = jnp.asarray(scan.angles, jnp.float32)
    ranges = jnp.broadcast_to(jnp.asarray(scan.ranges, jnp.float32),
                              angles.shape)
    mask = jnp.asarray(scan.mask, jnp.float32)
    return fn(particles[None], angles, ranges[None], mask[None])[0]


def ray_disc_distance(ox, oy, angle, cx, cy, radius, max_range):
    """Distance along the ray to a disc obstacle (max_range if missed).

    Closed-form ray/circle intersection — models UNMAPPED dynamic
    obstacles (a person crossing the maze): the scan sees them, the map
    raster the filter matches against does not.
    """
    dx = jnp.cos(angle)
    dy = jnp.sin(angle)
    fx = ox - cx
    fy = oy - cy
    b = fx * dx + fy * dy                       # |d| = 1
    c = fx * fx + fy * fy - radius * radius
    disc = b * b - c
    t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
    hit = (disc >= 0.0) & (t >= 0.0) & (t < max_range)
    return jnp.where(hit, t, max_range)


def simulate_scan(m: MazeMap, pose, scan_angles, cfg: SensorModelConfig,
                  key: Optional[jax.Array] = None,
                  noise_sigma: Optional[float] = None,
                  dropout_p: float = 0.0, outlier_p: float = 0.0,
                  obstacle=None) -> Scan:
    """Generate an observed scan from a ground-truth pose.

    Uses the same geometry the filter predicts with (offset + negation), so a
    particle at the true pose scores the maximum-likelihood weight.  Optional
    Gaussian range noise; ranges clamp to [0, max_range].

    Robustness knobs (all need `key`):
      * dropout_p — per-beam probability of returning the NaN-replacement
        radius (cfg.invalid_beam_range), i.e. the reference's dead-beam
        path (monte_carlo.cpp:254-278) exercised synthetically;
      * outlier_p — per-beam probability of a uniform [0, max_range)
        spurious return (exercises the w_rand mixture term);
      * obstacle — (cx, cy, radius): unmapped disc the rays hit first.
    """
    pose = jnp.asarray(pose, jnp.float32)
    angles_arr = jnp.asarray(scan_angles, jnp.float32)
    ranges = expected_ranges(m, pose, angles_arr, cfg)
    if obstacle is not None:
        cx, cy, radius = obstacle
        x, y, theta = pose[..., 0], pose[..., 1], pose[..., 2]
        ox = x + cfg.laser_offset * jnp.cos(theta)
        oy = y + cfg.laser_offset * jnp.sin(theta)
        sign = -1.0 if cfg.negate_beam_angle else 1.0
        ray_angle = theta[..., None] + sign * angles_arr
        d_obs = ray_disc_distance(ox[..., None], oy[..., None], ray_angle,
                                  cx, cy, radius, cfg.max_range)
        ranges = jnp.minimum(ranges, d_obs)
    if key is not None:
        k_noise, k_drop, k_out, k_outv = jax.random.split(key, 4)
        sigma = cfg.sigma if noise_sigma is None else noise_sigma
        ranges = ranges + sigma * jax.random.normal(k_noise, ranges.shape)
        ranges = jnp.clip(ranges, 0.0, cfg.max_range)
        if outlier_p > 0.0:
            spurious = jax.random.uniform(k_outv, ranges.shape,
                                          maxval=cfg.max_range)
            ranges = jnp.where(
                jax.random.uniform(k_out, ranges.shape) < outlier_p,
                spurious, ranges)
        if dropout_p > 0.0:
            ranges = jnp.where(
                jax.random.uniform(k_drop, ranges.shape) < dropout_p,
                cfg.invalid_beam_range, ranges)
        return make_scan(scan_angles, ranges)
    ranges = jnp.clip(ranges, 0.0, cfg.max_range)
    return make_scan(scan_angles, ranges)
