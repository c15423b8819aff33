"""Rao-Blackwellized particle-filter SLAM (occupancy-grid FastSLAM).

No reference counterpart — the reference stack REQUIRES a hand-written
map.txt (publish_map.py) and localizes against it (monte_carlo.cpp); it has
no way to estimate pose and map jointly.  models/mapping.py closed half the
loop (build a map from known/dead-reckoned poses); this module closes it
fully: each particle carries a pose hypothesis AND its own occupancy grid,
so the robot localizes in the map it is simultaneously building — nothing
but encoders + scans in, (pose, map) posterior out.

Design decisions:

* The map posterior is P dense [H, W] log-odds grids carried as ONE
  [P, H, W] array.  P is small (FastSLAM operates at tens of particles);
  the per-tick map update is the existing dense inverse sensor model
  (models/mapping.update_map) vmapped over particles — [P, H, W, B]
  broadcast compute, zero scatter.
* The weight model is a likelihood field over each particle's OWN map:
  per returned beam, bilinearly sample P(occupied) at the scan endpoint
  and score l = z_hit * P(occ) + z_rand.  The bilinear sample is a
  GATHER-FREE einsum: tent-function weights over the row/col axes
  (max(0, 1 - |coord - index|) is exactly linear interpolation) contract
  the [P, H, W] occupancy stack as matrix products; at P*B*H*W ~ 10^7
  MACs/tick the dense contraction is cheap (ROADMAP S7 measures it
  against a gather form).
* Because the sample is bilinear, the per-particle log-likelihood is
  DIFFERENTIABLE in the pose — `refine_iters` > 0 runs a few steps of
  gradient ascent per particle against its own map before weighting
  (GMapping's scan-matched proposal as autodiff, same trick as
  models/refine.py uses against the static map).
* Resampling is the framework's closed-form systematic expansion
  (models/resample.systematic_indices); particle maps ride the same index
  gather.  An ESS gate (Doucet's N_eff) keeps map copies rare: ticks that
  skip resampling touch only weights.
* Everything is a pure function of (state, tick inputs): episodes fold
  under `lax.scan` (run_slam_episode) and fleets of SLAM robots vmap.

Unknown cells sample P(occ) = 0.5, so before the map has evidence every
particle scores identically and the filter coasts on odometry — the
correct cold-start behavior, no special casing.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..config import SLAMConfig
from ..utils.angles import normalize_angle
from . import mapping, motion
from .resample import systematic_indices


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SLAMState:
    """Joint (pose, map) particle posterior + shared odometry integrator."""

    poses: jax.Array       # [P, 3] world (x, y, theta) hypotheses
    logodds: jax.Array     # [P, H, W] per-particle occupancy log-odds
    weights: jax.Array     # [P] normalized importance weights
    scores: jax.Array      # [P] last PRE-resample weights, permuted along
    #                        with the particles: on a resampled tick the
    #                        post-resample weights are uniform, so argmax
    #                        over them degenerates to particle 0 — the MAP
    #                        estimate (best_map/best_pose) selects on these
    odom: motion.OdometryState   # shared encoder integrator
    key: jax.Array         # PRNG carried through ticks
    kf_pose: jax.Array     # [3] posterior-mean pose at the last map
    #                        update (keyframe gating reference; a far
    #                        sentinel at init so the first tick always
    #                        maps — inert unless cfg.keyframe_* > 0)
    closure_cool: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.int32(0))
    #                        keyframes left before the closure may fire
    #                        again (cooldown breaks correction ratchets)
    log_evidence: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))
    #                        accumulated log marginal likelihood
    #                        sum_t log p(z_t | z_{1:t-1}): each tick adds
    #                        logsumexp over particles of log w_{t-1} +
    #                        loglik_t (the SIR evidence estimate).  The
    #                        model-selection statistic replica selection
    #                        keys on (run_slam_replicas).


def init_slam(key, start_pose, cfg: SLAMConfig) -> SLAMState:
    """All particles at the (known) start pose, empty maps, uniform weights.

    SLAM is anchored at the start pose by convention (the map frame is
    defined by it) — global relocalization on a learned map is the
    existing filter's job (models/filter + maps/grid.from_raster).
    """
    p = cfg.num_particles
    sp = jnp.asarray(start_pose, jnp.float32)
    poses = jnp.broadcast_to(sp, (p, 3)).astype(jnp.float32)
    logodds = jnp.zeros((p, cfg.mapping.height, cfg.mapping.width),
                        jnp.float32)
    weights = jnp.full((p,), 1.0 / p, jnp.float32)
    odom = motion.OdometryState.zero()
    odom = dataclasses.replace(odom, x=sp[0], y=sp[1], theta=sp[2])
    return SLAMState(poses=poses, logodds=logodds, weights=weights,
                     scores=weights, odom=odom, key=key,
                     kf_pose=jnp.full((3,), -1e6, jnp.float32))


def _endpoints(poses, ranges, angles, cfg: SLAMConfig):
    """Scan endpoints in world coords per (particle, beam): [P, B] x/y.

    Same sensor geometry as the filter and the mapper: ray origin
    `laser_offset` ahead of the pose (monte_carlo.cpp:643-645), beam angle
    negated under the reference convention (:653).
    """
    theta = poses[:, 2:3]                                   # [P, 1]
    ox = poses[:, 0:1] + cfg.sensor.laser_offset * jnp.cos(theta)
    oy = poses[:, 1:2] + cfg.sensor.laser_offset * jnp.sin(theta)
    sign = -1.0 if cfg.sensor.negate_beam_angle else 1.0
    ray = theta + sign * angles[None, :]                    # [P, B]
    # Sample at the WALL PIXEL CENTER, half a pixel past the near-face
    # return — where update_map deposits the hit mass ([r - hit_margin,
    # r + hit_depth]).  Sampling at exactly r would put the field peak
    # res/2 PAST every endpoint, a systematic forward-along-beam pull on
    # the whole cloud (measured: the bias compounds over an episode).
    r = ranges[None, :] + 0.5 * cfg.mapping.resolution
    return ox + r * jnp.cos(ray), oy + r * jnp.sin(ray)


def field_window_px(cfg: SLAMConfig) -> int:
    """Static per-particle window side (pixels) for the likelihood field.

    Must cover every point the scan model samples on a particle's map —
    endpoints at laser_offset + max_trusted_range + res/2 from the pose,
    free-space stations inside that — PLUS the blur kernel's reach
    (field_radius_px: a wall just outside the sampled hull still bleeds
    field mass onto it) and a 2 px margin for the refine hill-climb's
    pose motion (refine_iters * refine_step_xy << 1 px per default).
    """
    reach = (cfg.sensor.laser_offset + cfg.mapping.max_trusted_range
             + cfg.mapping.resolution)
    half = (int(math.ceil(reach / cfg.mapping.resolution))
            + cfg.field_radius_px + 2)
    return 2 * half + 1


def _window_origins(poses, cfg: SLAMConfig, sh: int, sw: int):
    """Top-left (row, col) of each particle's sh x sw window,
    border-clamped so the window always lies inside the [H, W] grid."""
    mcfg = cfg.mapping
    ci = jnp.floor((poses[:, 0] - mcfg.origin_x)
                   / mcfg.resolution).astype(jnp.int32)
    ri = jnp.floor((poses[:, 1] - mcfg.origin_y)
                   / mcfg.resolution).astype(jnp.int32)
    r0 = jnp.clip(ri - sh // 2, 0, mcfg.height - sh)
    c0 = jnp.clip(ci - sw // 2, 0, mcfg.width - sw)
    return r0, c0


def field_windows(logodds, poses, cfg: SLAMConfig):
    """Per-particle likelihood-field windows: ([P, s, s] log-odds slices,
    (r0 [P], c0 [P]) offsets), or (logodds, None) when the map is small
    enough that the window IS the map.

    THE map-scaling move (pairs with mapping.update_map's sensor window):
    the blur + bilinear contractions then run on s x s windows around
    each particle instead of the full [H, W] grid, so the per-tick SLAM
    cost stays ~flat in map AREA.  Every sample the scan model takes lies
    within the window by construction (field_window_px), so windowed
    log-likelihoods match the full-grid computation.
    """
    s = field_window_px(cfg)
    h, w = logodds.shape[-2], logodds.shape[-1]
    # Window only when it saves real work (≤ half the map side): on maps
    # near the window size the full-grid einsums are cheaper AND compile
    # faster than P vmapped dynamic_slices (the default 49 px maze stays
    # on the original path bit-for-bit).
    if 2 * s > min(h, w):
        return logodds, None
    sh, sw = min(s, h), min(s, w)
    r0, c0 = _window_origins(poses, cfg, sh, sw)
    win = jax.vmap(lambda lo, r, c: jax.lax.dynamic_slice(
        lo, (r, c), (sh, sw)))(logodds, r0, c0)
    return win, (r0, c0)


def _blur_matrix(n: int, sigma_px: float, radius: int):
    """Banded Toeplitz 1-D Gaussian with UNIT CENTER weight, [n, n].

    Unnormalized (k[0] = 1) so a learned wall keeps field value ~1 ON the
    wall and decays as exp(-d^2 / 2 sigma^2) off it — the AMCL
    likelihood-field shape, computed as two small matmuls instead of a
    distance transform (no scatter; matrix products at map sizes).
    """
    idx = jnp.arange(n, dtype=jnp.float32)
    d = jnp.abs(idx[:, None] - idx[None, :])
    k = jnp.exp(-0.5 * (d / sigma_px) ** 2)
    return jnp.where(d <= radius, k, 0.0)


def hit_field(logodds, cfg: SLAMConfig):
    """Likelihood fields: (blurred [P, H, W], sharp [P, H, W]).

    wallness = sigmoid(4 * (logodds - l_occ / 2)) keeps unknown (0) and
    free (negative) cells near zero yet counts a SINGLE hit observation
    as ~0.86 wall — fresh evidence must discriminate immediately or the
    filter coasts blind through newly-entered corridors.  The blurred
    field (separable banded-matmul Gaussian, clipped at 1 where walls
    overlap) widens each wall into a smooth basin for the ENDPOINT model
    and the gradient scan matcher — the blur is what gives a particle
    2-3 pixels off a non-zero pull back toward alignment.  The SHARP
    wallness is kept for the free-space consistency term: a 1.5 px blur
    reaches ~0.4 m off every wall, which covers the whole corridor
    interior — crossing detection against the blurred field punishes
    every ray everywhere (measured to sink the filter).
    """
    h, w = logodds.shape[-2], logodds.shape[-1]
    # Rebase the sigmoid so UNKNOWN (logodds 0) maps to EXACTLY zero wall
    # mass: the unnormalized blur kernel sums to ~14, so even a 0.14
    # sigmoid floor saturates the blurred field at 1.0 everywhere and the
    # endpoint model degenerates to a constant (caught by
    # test_hit_field_peak_on_wall_and_decay).
    s = jax.nn.sigmoid(4.0 * (logodds - 0.5 * cfg.mapping.l_occ))
    s0 = 1.0 / (1.0 + math.exp(2.0 * cfg.mapping.l_occ))
    wall = jnp.maximum(0.0, (s - s0) / (1.0 - s0))
    kh = _blur_matrix(h, cfg.field_sigma_px, cfg.field_radius_px)
    kw = _blur_matrix(w, cfg.field_sigma_px, cfg.field_radius_px)
    blurred = jnp.einsum("ia,pab,bj->pij", kh, wall, kw,
                         precision=jax.lax.Precision.HIGHEST)
    blurred = jnp.clip(blurred, 0.0, 1.0)
    return blurred, wall


def _bilinear(field, ex, ey, mcfg, offsets=None):
    """Bilinear world-point sampling of [P, h, w] fields, gather-free.

    ex/ey [P, B] -> [P, B].  Tent weights max(0, 1 - |coord - index|)
    over each axis ARE the bilinear interpolation coefficients; the
    double contraction runs as matrix products instead of per-lane
    gathers.  Samples outside the pixel-center hull
    read ZERO field mass (z_rand-only scoring), not the border cell: a
    particle drifting off the map must not be rewarded by the outer
    wall's own likelihood basin pulling its endpoints "onto" the border.

    `offsets` = (r0 [P], c0 [P]) when `field` holds per-particle WINDOWS
    of the full grid (field_windows): coordinates rebase into each
    particle's window; the out-of-hull gate still tests the FULL map
    bounds, so windowed and full-grid sampling agree wherever the window
    covers the sample (guaranteed by field_window_px for every point the
    scan model uses).
    """
    h, w = field.shape[-2], field.shape[-1]
    res = mcfg.resolution
    # Pixel-CENTER coordinates (update_map places centers at +0.5 * res).
    u = (ex - mcfg.origin_x) / res - 0.5                          # cols
    v = (ey - mcfg.origin_y) / res - 0.5                          # rows
    fh = mcfg.height if offsets is not None else h
    fw = mcfg.width if offsets is not None else w
    in_bounds = ((u >= 0.0) & (u <= fw - 1.0)
                 & (v >= 0.0) & (v <= fh - 1.0)).astype(field.dtype)
    if offsets is not None:
        r0, c0 = offsets
        u = u - c0[:, None].astype(u.dtype)
        v = v - r0[:, None].astype(v.dtype)
    u = jnp.clip(u, 0.0, w - 1.0)
    v = jnp.clip(v, 0.0, h - 1.0)
    rows = jnp.arange(h, dtype=jnp.float32)
    cols = jnp.arange(w, dtype=jnp.float32)
    row_w = jnp.maximum(0.0, 1.0 - jnp.abs(v[..., None] - rows))  # [P, B, h]
    col_w = jnp.maximum(0.0, 1.0 - jnp.abs(u[..., None] - cols))  # [P, B, w]
    return in_bounds * jnp.einsum("pbh,phw,pbw->pb", row_w, field, col_w,
                                   precision=jax.lax.Precision.HIGHEST)


def scan_log_likelihood(field, poses, ranges, angles, mask,
                        cfg: SLAMConfig, offsets=None):
    """Per-particle log-likelihood of the scan on each particle's field.

    Two terms per valid beam, both read off the same Gaussian-widened
    wall field of the particle's OWN map:

    * endpoint (returned beams only): l = z_hit * field(endpoint) +
      z_rand — the AMCL likelihood-field model;
    * free-space consistency (all valid beams): interior samples along
      the ray must NOT sit on a confident wall — each crossing multiplies
      the beam likelihood by (1 - z_short * field(s)).  The endpoint
      term alone is blind to pose drift ALONG extended walls (a maze is
      mostly axis-aligned planes); rays crossing previously-mapped walls
      are the strongest heading-drift signal a revisit provides.

    No-return beams skip the endpoint term (their endpoint is not
    evidence of a surface) but still contribute free-space consistency
    over their full length.  Returns [P].
    """
    field_hit, field_wall = field
    ranges = jnp.asarray(ranges, jnp.float32)
    ex, ey = _endpoints(poses, ranges, angles, cfg)
    f = _bilinear(field_hit, ex, ey, cfg.mapping, offsets)
    maskf = jnp.asarray(mask, jnp.float32)
    valid = maskf * (ranges <= cfg.mapping.max_trusted_range).astype(
        jnp.float32)
    returned = valid * (
        ranges < cfg.sensor.max_range - 1e-6).astype(jnp.float32)
    per_beam = jnp.log(cfg.z_hit * f + cfg.z_rand) * returned[None, :]
    if cfg.z_short > 0.0 and cfg.free_samples > 0:
        theta = poses[:, 2:3]
        ox = poses[:, 0:1] + cfg.sensor.laser_offset * jnp.cos(theta)
        oy = poses[:, 1:2] + cfg.sensor.laser_offset * jnp.sin(theta)
        sign = -1.0 if cfg.sensor.negate_beam_angle else 1.0
        ray = theta + sign * angles[None, :]
        cr, sr = jnp.cos(ray), jnp.sin(ray)
        # Interior stations at fractions of (r - free_margin): the margin
        # keeps the last station out of the endpoint wall's own blur
        # basin, so a correctly-placed wall is not punished as a crossing.
        # All K stations fold into the beam axis ([P, B*K]) so the whole
        # free-space term is ONE bilinear contraction, not K sequential
        # einsums.
        span = jnp.maximum(ranges[None, :] - cfg.free_margin, 0.0)
        fracs = (jnp.arange(1, cfg.free_samples + 1, dtype=jnp.float32)
                 / cfg.free_samples)
        s = span[..., None] * fracs                         # [1, B, K]
        p_n, b_n, k_n = poses.shape[0], ranges.shape[-1], cfg.free_samples
        sx = jnp.broadcast_to(ox[..., None] + s * cr[..., None],
                              (p_n, b_n, k_n)).reshape(p_n, b_n * k_n)
        sy = jnp.broadcast_to(oy[..., None] + s * sr[..., None],
                              (p_n, b_n, k_n)).reshape(p_n, b_n * k_n)
        fk = _bilinear(field_wall, sx, sy, cfg.mapping, offsets).reshape(
            p_n, b_n, k_n)
        per_beam = per_beam + (
            jnp.sum(jnp.log1p(-cfg.z_short * fk), axis=-1)
            * valid[None, :])
    return jnp.sum(per_beam, axis=-1)


def scan_loglik_multi(field, cand, ranges, angles, mask, cfg: SLAMConfig,
                      offsets=None):
    """scan_log_likelihood for [P, K, 3] candidate poses, returns [P, K].

    All K candidates of particle p score against p's OWN field (window):
    K folds into the SAMPLE axis of the per-particle bilinear
    contractions (_bilinear handles any [P, M]), so the field stack is
    read once per particle regardless of K — the tent-weight einsums
    just get a K× longer sample axis.  Same two terms as
    scan_log_likelihood (endpoint + free-space consistency); K = 1
    column-matches it exactly (pinned by test_slam)."""
    field_hit, field_wall = field
    ranges = jnp.asarray(ranges, jnp.float32)
    p_n, k_n, _ = cand.shape
    b_n = ranges.shape[-1]
    theta = cand[..., 2:3]                                   # [P, K, 1]
    ox = cand[..., 0:1] + cfg.sensor.laser_offset * jnp.cos(theta)
    oy = cand[..., 1:2] + cfg.sensor.laser_offset * jnp.sin(theta)
    sign = -1.0 if cfg.sensor.negate_beam_angle else 1.0
    ray = theta + sign * angles[None, None, :]               # [P, K, B]
    r = ranges[None, None, :] + 0.5 * cfg.mapping.resolution
    ex = (ox + r * jnp.cos(ray)).reshape(p_n, k_n * b_n)
    ey = (oy + r * jnp.sin(ray)).reshape(p_n, k_n * b_n)
    f = _bilinear(field_hit, ex, ey, cfg.mapping, offsets).reshape(
        p_n, k_n, b_n)
    maskf = jnp.asarray(mask, jnp.float32)
    valid = maskf * (ranges <= cfg.mapping.max_trusted_range).astype(
        jnp.float32)
    returned = valid * (
        ranges < cfg.sensor.max_range - 1e-6).astype(jnp.float32)
    per_beam = jnp.log(cfg.z_hit * f + cfg.z_rand) * returned[None, None, :]
    if cfg.z_short > 0.0 and cfg.free_samples > 0:
        cr, sr = jnp.cos(ray), jnp.sin(ray)
        span = jnp.maximum(ranges[None, None, :] - cfg.free_margin, 0.0)
        fracs = (jnp.arange(1, cfg.free_samples + 1, dtype=jnp.float32)
                 / cfg.free_samples)
        s = span[..., None] * fracs                          # [1, 1, B, F]
        f_n = cfg.free_samples
        sx = jnp.broadcast_to(ox[..., None] + s * cr[..., None],
                              (p_n, k_n, b_n, f_n)).reshape(
                                  p_n, k_n * b_n * f_n)
        sy = jnp.broadcast_to(oy[..., None] + s * sr[..., None],
                              (p_n, k_n, b_n, f_n)).reshape(
                                  p_n, k_n * b_n * f_n)
        fk = _bilinear(field_wall, sx, sy, cfg.mapping, offsets).reshape(
            p_n, k_n, b_n, f_n)
        per_beam = per_beam + (
            jnp.sum(jnp.log1p(-cfg.z_short * fk), axis=-1)
            * valid[None, None, :])
    return jnp.sum(per_beam, axis=-1)                        # [P, K]


def _refine_poses(poses, field, ranges, angles, mask, cfg: SLAMConfig,
                  offsets=None):
    """Gradient scan matching against each particle's OWN likelihood field.

    A few steps of sign-gradient ascent on the differentiable endpoint
    likelihood, per-particle accept-if-better (the same safeguarded
    hill-climb as models/refine.py, but the 'map' here is the particle's
    learned grid, so refinement sharpens the SLAM proposal exactly where
    GMapping applies its scan matcher).  The Gaussian-widened field gives
    the gradient ~field_radius_px pixels of reach.  Fields are constants
    here (stop_gradient) — only the pose moves.
    """
    lo = jax.lax.stop_gradient(field)

    def score(p):
        return scan_log_likelihood(lo, p, ranges, angles, mask, cfg,
                                   offsets)

    def one_iter(carry, _):
        p, s = carry
        g = jax.grad(lambda q: jnp.sum(score(q)))(p)
        step = jnp.array([cfg.refine_step_xy, cfg.refine_step_xy,
                          cfg.refine_step_theta], jnp.float32)
        cand = p + step * jnp.sign(g)
        s_cand = score(cand)
        better = s_cand > s
        return (jnp.where(better[:, None], cand, p),
                jnp.where(better, s_cand, s)), None

    (refined, _), _ = jax.lax.scan(
        one_iter, (poses, score(poses)), None, length=cfg.refine_iters)
    return refined


def consensus_map(state: SLAMState):
    """Importance-weighted mean of the particle log-odds grids: [H, W].

    The accumulated-evidence artifact the closure matches against (and a
    better export than any single particle's map once trajectories
    disagree: misaligned smear averages toward zero log-odds = unknown,
    while consistently-observed walls reinforce).
    """
    return jnp.einsum("p,phw->hw", state.weights, state.logodds,
                      precision=jax.lax.Precision.HIGHEST)


def closure_correction(logodds, w, mean_pose, ranges, angles, mask,
                       cfg: SLAMConfig):
    """Correlative scan match against the CONSENSUS map: (delta [3], gain).

    Scores the scan from candidate poses mean_pose + (dx, dy, dtheta) on
    an exhaustive odd grid against the likelihood field of the
    importance-weighted MEAN map — the map the cloud has collectively
    painted so far.  Returns the best offset (zeros unless it beats the
    zero offset by >= closure_margin nats) and the raw gain.  Gather-free:
    all C candidates fold into the sample axis of ONE gather-free bilinear
    contraction over a single consensus field (scan_loglik_multi with
    P=1, K=C); on large maps the field is one shared window around the
    mean pose, widened by the search range.
    """
    mcfg = cfg.mapping
    h, wd = mcfg.height, mcfg.width
    pad = int(math.ceil(cfg.closure_xy_range / mcfg.resolution)) + 1
    s = field_window_px(cfg) + 2 * pad
    if 2 * s > min(h, wd):
        cons = jnp.einsum("p,phw->hw", w, logodds,
                          precision=jax.lax.Precision.HIGHEST)[None]
        offsets = None
    else:
        sh, sw = min(s, h), min(s, wd)
        r0, c0 = _window_origins(mean_pose[None, :], cfg, sh, sw)
        win = jax.vmap(lambda lo: jax.lax.dynamic_slice(
            lo, (r0[0], c0[0]), (sh, sw)))(logodds)
        cons = jnp.einsum("p,phw->hw", w, win,
                          precision=jax.lax.Precision.HIGHEST)[None]
        offsets = (r0, c0)
    field = hit_field(cons, cfg)
    nxy, nth = cfg.closure_xy_steps, cfg.closure_theta_steps
    assert nxy % 2 == 1 and nth % 2 == 1, "closure steps must be odd"
    dx = jnp.linspace(-cfg.closure_xy_range, cfg.closure_xy_range, nxy)
    dth = jnp.linspace(-cfg.closure_theta_range, cfg.closure_theta_range,
                       nth)
    gx, gy, gt = jnp.meshgrid(dx, dx, dth, indexing="ij")
    deltas = jnp.stack([gx.ravel(), gy.ravel(), gt.ravel()],
                       axis=-1).astype(jnp.float32)          # [C, 3]
    cand = mean_pose[None, None, :] + deltas[None]           # [1, C, 3]

    # Frontier-suction gate.  Matching against an INCOMPLETE map rewards
    # shifting the cloud backward: endpoints beyond the painted frontier
    # read zero field, and any offset dragging them onto already-painted
    # walls gains likelihood regardless of alignment (measured: -0.10 m
    # along-heading per fired correction, compounding to meters of
    # drift).  The match therefore scores only RETURNED beams whose
    # endpoint — at the CENTER pose, so the scored beam set is candidate-
    # independent — already reads real wall mass off the consensus field:
    # the wall that beam is hitting IS painted, so candidate shifts move
    # its endpoint around a genuine basin instead of across the frontier.
    # No-return beams are dropped outright (their only closure signal
    # would be free-space stations crossing painted walls, which near the
    # frontier turns into a reverse suction that pushes the cloud AWAY
    # from painted space).  A minimum matched-beam count gates the whole
    # correction: two or three surviving beams cannot rigidly re-anchor a
    # cloud.
    rr = jnp.asarray(ranges, jnp.float32)
    ex_c, ey_c = _endpoints(mean_pose[None, :], rr, angles, cfg)
    f_c = _bilinear(field[0], ex_c, ey_c, cfg.mapping, offsets)[0]  # [B]
    returned_c = (rr < cfg.sensor.max_range - 1e-6)
    beam_ok = (f_c > 0.3) & returned_c
    mask = jnp.asarray(mask, jnp.float32) * beam_ok.astype(jnp.float32)
    n_matched = jnp.sum(mask)

    ll = scan_loglik_multi(field, cand, ranges, angles, mask, cfg,
                           offsets)[0]                       # [C]
    center = (nxy // 2) * nxy * nth + (nxy // 2) * nth + nth // 2
    best = jnp.argmax(ll)
    # Rotation is weakly observable in corridors (endpoints slide ALONG
    # extended walls), so the raw argmax often carries a spurious grid-
    # edge dtheta.  Keep the theta component only when it independently
    # buys closure_theta_margin nats over dtheta = 0 at the same (dx, dy).
    best_xy0 = best - best % nth + nth // 2
    use_theta = (ll[best] - ll[best_xy0]) >= cfg.closure_theta_margin
    best = jnp.where(use_theta, best, best_xy0)
    gain = ll[best] - ll[center]
    fire = ((gain >= cfg.closure_margin)
            & (n_matched >= cfg.closure_min_beams))
    delta = jnp.where(fire, cfg.closure_gain * deltas[best],
                      jnp.zeros(3, jnp.float32))
    return delta, gain


def _apply_rigid_delta(poses, mean_pose, delta):
    """Rigid cloud transform: rotate by delta theta about the posterior
    mean, translate by (dx, dy) — relative particle spread is preserved,
    so the correction re-anchors the cloud without collapsing diversity."""
    c, s = jnp.cos(delta[2]), jnp.sin(delta[2])
    rx = poses[:, 0] - mean_pose[0]
    ry = poses[:, 1] - mean_pose[1]
    nx = mean_pose[0] + delta[0] + c * rx - s * ry
    ny = mean_pose[1] + delta[1] + s * rx + c * ry
    nt = normalize_angle(poses[:, 2] + delta[2])
    return jnp.stack([nx, ny, nt], axis=-1)


def slam_step(state: SLAMState, encoder_left, encoder_right, ranges,
              angles, mask, cfg: SLAMConfig):
    """One SLAM tick: propose (odometry + noise), weight (scan vs own map),
    resample (ESS-gated, maps ride along), map-update (vmapped dense ISM).

    Returns (new_state, info) with info = dict(pose [3] weighted-mean
    estimate, best_pose [3], ess, resampled flag).
    """
    p_count = cfg.num_particles
    k_cand = cfg.proposal_candidates
    if k_cand > 1:
        k_noise, k_pick, k_draw, k_next = jax.random.split(state.key, 4)
    else:
        k_noise, k_draw, k_next = jax.random.split(state.key, 3)

    # 1. Motion proposal: shared encoder integration, PER-PARTICLE noise
    # (diversity is the SLAM proposal; the reference's shared-noise quirk
    # would collapse it).  alpha_scale inflates the localization alphas —
    # the proposal must cover odometry error before the map can correct it.
    new_odom, rot1, trans, rot2 = motion.diff_drive_update(
        state.odom, encoder_left, encoder_right, cfg.motion)
    # Guarded decomposition for in-place turns: with trans ~ 0 the
    # reference's rot1 = atan2(~0, ~0) - theta_prev is numerical garbage
    # of magnitude O(pi), and alpha_1 * |rot1| then injects degrees of
    # heading noise PER TICK during every turn (the localization filter
    # keeps the quirk for parity; SLAM cannot afford it — measured to
    # blow up heading error at every wander turn).  With trans ~ 0 the
    # split between rot1 and rot2 is unobservable, so rot1 = 0,
    # rot2 = delta_theta is an equivalent decomposition.
    turning_in_place = trans < 1e-4
    rot2 = jnp.where(turning_in_place, rot1 + rot2, rot2)
    rot1 = jnp.where(turning_in_place, 0.0, rot1)
    mcfg = dataclasses.replace(
        cfg.motion,
        alpha_1=cfg.motion.alpha_1 * cfg.alpha_scale,
        alpha_2=cfg.motion.alpha_2 * cfg.alpha_scale,
        alpha_3=cfg.motion.alpha_3 * cfg.alpha_scale,
        alpha_4=cfg.motion.alpha_4 * cfg.alpha_scale)
    ranges = jnp.asarray(ranges, jnp.float32)
    angles = jnp.asarray(angles, jnp.float32)
    mask = jnp.asarray(mask, jnp.float32)

    if k_cand > 1:
        # 2-3. Monte-Carlo OPTIMAL proposal (Doucet's p(x|x_prev, z) via K
        # auxiliary candidates): K independent motion-model draws per
        # particle, ONE kept with probability ∝ its scan likelihood
        # (Gumbel-max categorical — no gathers, a one-hot select),
        # and the importance weight multiplied by the candidate MEAN
        # likelihood — an unbiased estimate of the optimal-proposal
        # normalizer ∫ p(z|x) p(x|x_prev) dx.  Unlike the deterministic
        # hill-climb (refine_iters, measured to HURT — QUIRKS.md), the
        # weights stay exact for ANY K; K=1 degenerates to plain SIR.
        # Fields/windows are computed once per particle at the noise-free
        # composed pose (candidates lie within the motion-noise radius,
        # well inside the window margin) and shared across K.
        n_rot1, n_trans, n_rot2 = motion.sample_motion_noise(
            k_noise, rot1, trans, rot2, mcfg, (p_count, k_cand))
        cand = motion.propagate_particles(
            state.poses[:, None, :], n_rot1, n_trans, n_rot2)
        cand = cand.at[..., 2].set(normalize_angle(cand[..., 2]))
        center = motion.propagate_particles(state.poses, rot1, trans, rot2)
        win, offsets = field_windows(state.logodds, center, cfg)
        field = hit_field(win, cfg)
        ll = scan_loglik_multi(field, cand, ranges, angles, mask, cfg,
                               offsets)                      # [P, K]
        gum = -jnp.log(-jnp.log(jax.random.uniform(
            k_pick, (p_count, k_cand), minval=jnp.float32(1e-37),
            maxval=1.0)))
        pick = jnp.argmax(ll + gum, axis=1)
        onehot = jax.nn.one_hot(pick, k_cand, dtype=cand.dtype)
        poses = jnp.einsum("pk,pkd->pd", onehot, cand,
                           precision=jax.lax.Precision.HIGHEST)
        loglik = (jax.scipy.special.logsumexp(ll, axis=1)
                  - jnp.log(jnp.float32(k_cand)))
    else:
        n_rot1, n_trans, n_rot2 = motion.sample_motion_noise(
            k_noise, rot1, trans, rot2, mcfg, (p_count,))
        poses = motion.propagate_particles(state.poses, n_rot1, n_trans,
                                           n_rot2)
        poses = poses.at[:, 2].set(normalize_angle(poses[:, 2]))

        # Likelihood field of each particle's PRE-UPDATE map, computed
        # once per tick and shared by the scan matcher and the weighting
        # below.  On maps larger than field_window_px the field is a
        # per-particle window around the (pre-refine) proposal pose —
        # per-tick cost stays flat in map AREA (field_windows).
        win, offsets = field_windows(state.logodds, poses, cfg)
        field = hit_field(win, cfg)

        # 2. Optional gradient scan matching (sharpen the proposal).
        if cfg.refine_iters > 0:
            poses = _refine_poses(poses, field, ranges, angles, mask, cfg,
                                  offsets)

        # 3. Weight on the PRE-UPDATE maps (measure against evidence from
        # previous scans only — weighting against a map that already
        # contains this scan would be circular).
        loglik = scan_log_likelihood(field, poses, ranges, angles, mask,
                                     cfg, offsets)
    logw = jnp.log(state.weights) + loglik
    # SIR evidence increment: log p(z_t | z_{1:t-1}) ~= logsumexp(logw)
    # (weights are normalized, so no 1/N correction).
    log_evidence = (state.log_evidence
                    + jax.scipy.special.logsumexp(logw))
    logw = logw - jnp.max(logw)
    w = jnp.exp(logw)
    w = w / jnp.sum(w)

    # 4. ESS-gated systematic resampling; maps AND the pre-resample
    # scores ride the same indices (scores keep the MAP-estimate argmax
    # meaningful on ticks where w collapses to uniform).
    ess = 1.0 / jnp.sum(w * w)

    def _resample(operand):
        ps, lo, ww, sc = operand
        cdf = jnp.cumsum(ww)
        u0 = jax.random.uniform(k_draw, ())
        idx = systematic_indices(cdf, u0)
        return (ps[idx], lo[idx],
                jnp.full((p_count,), 1.0 / p_count, jnp.float32),
                sc[idx])

    poses, logodds, w, scores = jax.lax.cond(
        ess < cfg.ess_threshold * p_count,
        _resample, lambda op: op, (poses, state.logodds, w, w))

    # Pose estimate (weighted mean, circular theta) — computed before the
    # map update so keyframe gating can read it; the update does not move
    # poses, so the estimate is unchanged by the ordering.
    mx = jnp.sum(w * poses[:, 0])
    my = jnp.sum(w * poses[:, 1])
    mt = jnp.arctan2(jnp.sum(w * jnp.sin(poses[:, 2])),
                     jnp.sum(w * jnp.cos(poses[:, 2])))
    mean_pose = jnp.stack([mx, my, mt])

    # Keyframe criterion, evaluated before the map update so the closure
    # correction can run on exactly the ticks that are about to paint.
    crit = []
    if cfg.keyframe_trans > 0.0:
        crit.append(jnp.hypot(mean_pose[0] - state.kf_pose[0],
                              mean_pose[1] - state.kf_pose[1])
                    >= cfg.keyframe_trans)
    if cfg.keyframe_rot > 0.0:
        crit.append(jnp.abs(normalize_angle(mean_pose[2]
                                            - state.kf_pose[2]))
                    >= cfg.keyframe_rot)
    moved = jnp.bool_(True)
    for i, c in enumerate(crit):
        moved = c if i == 0 else (moved | c)

    # 4b. Consensus-anchored correlative correction (opt-in): before the
    # scan is painted, re-anchor the WHOLE cloud onto the accumulated
    # consensus evidence (closure_correction).  Applied rigidly so the
    # particle spread — the RBPF's trajectory hypotheses — survives; a
    # flat likelihood surface (unexplored space) never crosses the margin
    # and leaves the cloud untouched.  Three ratchet-breakers (a wrong
    # correction that gets painted justifies the NEXT correction —
    # measured to run away 0.04 -> 1.6 m in 60 ticks without them):
    # no firing on turning ticks (mid-turn scans are the least reliable
    # anchors and the rot-keyframe criterion fires exactly then), a
    # cooldown of `closure_cooldown` keyframes after each firing, and —
    # below — a fired tick SKIPS its own map update, so a correction must
    # survive the next keyframe's re-match before it may paint.
    closure_delta = jnp.zeros(3, jnp.float32)
    fired = jnp.bool_(False)
    closure_cool = state.closure_cool
    if cfg.closure:
        turn_ok = jnp.abs(rot1 + rot2) < cfg.closure_max_turn
        can_fire = moved & turn_ok & (closure_cool <= 0)
        closure_delta, _gain = jax.lax.cond(
            can_fire,
            lambda _: closure_correction(logodds, w, mean_pose, ranges,
                                         angles, mask, cfg),
            lambda _: (jnp.zeros(3, jnp.float32), jnp.float32(0.0)),
            None)
        poses = _apply_rigid_delta(poses, mean_pose, closure_delta)
        mean_pose = jnp.stack([
            mean_pose[0] + closure_delta[0],
            mean_pose[1] + closure_delta[1],
            normalize_angle(mean_pose[2] + closure_delta[2])])
        fired = jnp.sum(jnp.abs(closure_delta)) > 0.0
        closure_cool = jnp.where(
            fired, jnp.int32(cfg.closure_cooldown),
            jnp.maximum(closure_cool - moved.astype(jnp.int32), 0))

    # 5. Map update: each surviving particle folds the scan into ITS map
    # at ITS pose (vmapped dense inverse sensor model, zero scatter).
    # Keyframe-gated when cfg.keyframe_* > 0: stationary / turning ticks
    # re-paint the same walls from slightly different noisy poses — the
    # dominant long-horizon smear source — so the scan only enters the
    # maps once the posterior-mean pose moved a keyframe step.
    def _update_maps(lo):
        return jax.vmap(
            lambda l, p: mapping.update_map(l, p, ranges, angles, mask,
                                            cfg.mapping, cfg.sensor)
        )(lo, poses)

    do_paint = moved & ~fired if crit else ~fired
    if crit:
        logodds = jax.lax.cond(do_paint, _update_maps, lambda lo: lo,
                               logodds)
        kf_pose = jnp.where(moved, mean_pose, state.kf_pose)
        mapped = do_paint
    else:
        logodds = jax.lax.cond(do_paint, _update_maps, lambda lo: lo,
                               logodds) if cfg.closure else _update_maps(
                                   logodds)
        kf_pose = mean_pose
        mapped = do_paint

    best = jnp.argmax(scores)
    info = dict(pose=mean_pose,
                best_pose=poses[best],
                ess=ess,
                resampled=ess < cfg.ess_threshold * p_count,
                mapped=mapped,
                closure_delta=closure_delta)
    info["log_evidence"] = log_evidence
    new_state = SLAMState(poses=poses, logodds=logodds, weights=w,
                          scores=scores, odom=new_odom, key=k_next,
                          kf_pose=kf_pose, closure_cool=closure_cool,
                          log_evidence=log_evidence)
    return new_state, info


def run_slam_episode(key, encoders, scan_ranges, scan_angles,
                     cfg: SLAMConfig, start_pose, scan_mask=None,
                     state0: "SLAMState" = None):
    """Fold a whole episode under `lax.scan`.

    encoders [T, 2] cumulative wheel radians, scan_ranges [T, B],
    scan_angles [B] static.  Returns (final SLAMState, per-tick pose
    estimates [T, 3]).  vmap over a leading episode axis for parallel
    SLAM robots.  `state0` (optional) resumes from a carried state
    instead of init_slam(key, ...) — the host-chunked runner's hook.
    """
    angles = jnp.asarray(scan_angles, jnp.float32)
    ranges = jnp.asarray(scan_ranges, jnp.float32)
    if scan_mask is None:
        scan_mask = jnp.ones(ranges.shape, jnp.float32)
    state = init_slam(key, start_pose, cfg) if state0 is None else state0

    def body(st, xs):
        enc, rng, msk = xs
        st, info = slam_step(st, enc[0], enc[1], rng, angles, msk, cfg)
        return st, info["pose"]

    final, poses = jax.lax.scan(
        body, state,
        (jnp.asarray(encoders, jnp.float32), ranges,
         jnp.asarray(scan_mask, jnp.float32)))
    return final, poses


def run_slam_episode_chunked(key, encoders, scan_ranges, scan_angles,
                             cfg: SLAMConfig, start_pose,
                             tick_chunk: int, scan_mask=None):
    """run_slam_episode in host-synced tick segments — BIT-IDENTICAL
    (the per-tick RNG rides in the carried state).

    Each segment is one dispatch, followed by a host sync; a host round
    trip per segment costs ~ms.  vmap over a leading axis works on each
    segment exactly as on the full scan.
    """
    t = jnp.asarray(encoders).shape[0]
    ranges = jnp.asarray(scan_ranges, jnp.float32)
    if scan_mask is None:
        scan_mask = jnp.ones(ranges.shape, jnp.float32)
    state = init_slam(key, start_pose, cfg)
    chunks = []
    for t0 in range(0, t, tick_chunk):
        sl = slice(t0, min(t0 + tick_chunk, t))
        state, poses = run_slam_episode(
            key, jnp.asarray(encoders)[sl], ranges[sl], scan_angles,
            cfg, start_pose, scan_mask=scan_mask[sl], state0=state)
        jax.block_until_ready(state.poses)      # bound execution time
        chunks.append(poses)
    return state, jnp.concatenate(chunks, axis=0)


def run_slam_replicas(key, encoders, scan_ranges, scan_angles,
                      cfg: SLAMConfig, start_pose, replicas: int = 4,
                      scan_mask=None, tick_chunk=None):
    """K independent SLAM replicas over the SAME episode, selected by
    accumulated log marginal likelihood.

    The per-episode failure mode at high wheel slip is an alias MISLOCK:
    one unlucky proposal stream paints an early wall slightly off, the
    filter locks to its own wrong map, and the episode's F1/pose land in
    the tail (BENCH_DETAILS round-5 per-episode forensics).  Replicas
    differ ONLY in the RNG stream; the SIR evidence estimate
    sum_t logsumexp_p(log w_{t-1,p} + loglik_t,p) (SLAMState.log_evidence)
    is each replica's log p(z_{1:T}) — the principled model-selection
    statistic, computed for free inside the step.  vmap makes the K
    replicas one device program (embarrassingly parallel — the batched
    answer to an inherently sequential filter's seed sensitivity).

    Returns (final state of the winner, est poses [T, 3] of the winner,
    info dict with per-replica evidence and the chosen index).
    """
    keys = jax.random.split(key, replicas)
    if tick_chunk:
        # Host-synced segments of tick_chunk ticks, one dispatch each.
        # BIT-IDENTICAL to the one-scan path: the per-tick RNG rides the
        # carried state and init uses the same split keys.
        ranges = jnp.asarray(scan_ranges, jnp.float32)
        mask = (jnp.ones(ranges.shape, jnp.float32) if scan_mask is None
                else jnp.asarray(scan_mask, jnp.float32))
        states = jax.jit(jax.vmap(
            lambda k: init_slam(k, start_pose, cfg)))(keys)
        seg = jax.jit(jax.vmap(
            lambda k, st, e, r, mk: run_slam_episode(
                k, e, r, scan_angles, cfg, start_pose, scan_mask=mk,
                state0=st),
            in_axes=(0, 0, None, None, None)))
        t = jnp.asarray(encoders).shape[0]
        chunks = []
        for t0 in range(0, t, tick_chunk):
            sl = slice(t0, min(t0 + tick_chunk, t))
            states, est = seg(keys, states, jnp.asarray(encoders)[sl],
                              ranges[sl], mask[sl])
            jax.block_until_ready(states.poses)
            chunks.append(est)
        finals, ests = states, jnp.concatenate(chunks, axis=1)
    else:
        finals, ests = jax.vmap(
            lambda k: run_slam_episode(k, encoders, scan_ranges,
                                       scan_angles, cfg, start_pose,
                                       scan_mask))(keys)
    best = jnp.argmax(finals.log_evidence)
    final = jax.tree_util.tree_map(lambda x: x[best], finals)
    return final, ests[best], dict(
        log_evidence=finals.log_evidence, chosen=best)


def best_map(state: SLAMState):
    """Highest-SCORE particle's log-odds grid (the MAP map estimate).

    Selects on the last pre-resample weights (SLAMState.scores), not the
    current weights: immediately after a resample the weights are uniform
    and argmax over them degenerates to particle 0.
    """
    return state.logodds[jnp.argmax(state.scores)]


def best_pose(state: SLAMState):
    """Highest-score particle's pose (pairs with best_map)."""
    return state.poses[jnp.argmax(state.scores)]
