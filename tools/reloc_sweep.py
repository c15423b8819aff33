"""Partial-map relocalization sweep: the measurement harness behind
BENCH_DETAILS' round-5 reloc table (r4 VERDICT #2).

Synthetic half-explored default maze (right half unknown); fresh wander
episodes sense the TRUE maze, the filter runs on the conservative
learned fit with the unknown-aware scorer (known_map).  Sweeps credit
modes, injection/seeding modes, particle counts, the production
schedule, and evidence-selected replicas:

    python tools/reloc_sweep.py --ticks 300 --batch 16 --seeds 7 11 23 \
        --credit-mode interval --replicas 8
"""
import sys, argparse
import os.path as osp
sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))
import jax, jax.numpy as jnp, numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--ticks", type=int, default=300)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seed", type=int, default=7)
ap.add_argument("--credit", type=float, default=None)
ap.add_argument("--credit-mode", default=None)
ap.add_argument("--inject-mode", default=None, choices=["explored", "uniform", "init-only"])
ap.add_argument("--seeds", type=int, nargs="+", default=None)
ap.add_argument("--ess", type=float, default=None)
ap.add_argument("--refine", type=int, default=0)
ap.add_argument("--method", default=None, choices=["systematic", "multinomial"])
ap.add_argument("--particles", type=int, default=1500)
ap.add_argument("--replicas", type=int, default=1)
ap.add_argument("--cpu", action="store_true")
args = ap.parse_args()
if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import dataclasses
from montecarlolocalisation import presets
from montecarlolocalisation.models import mapping
from montecarlolocalisation.presets import _maze_from_wall_tensor
from montecarlolocalisation.parallel import episodes

world = presets.make_world(num_particles=args.particles, num_beams=24,
                           refine_iters=args.refine, ess_threshold=args.ess)
if args.method is not None:
    world = dataclasses.replace(world, cfg=dataclasses.replace(
        world.cfg, resample=dataclasses.replace(
            world.cfg.resample, method=args.method)))
scfg = world.cfg.sensor
icfg = world.cfg.init
if args.credit is not None:
    scfg = dataclasses.replace(scfg, unknown_credit=args.credit)
if args.credit_mode is not None:
    scfg = dataclasses.replace(scfg, unknown_credit_mode=args.credit_mode)
if args.inject_mode is not None:
    icfg = dataclasses.replace(icfg, partial_map_cells=args.inject_mode)
world = dataclasses.replace(
    world, cfg=dataclasses.replace(world.cfg, sensor=scfg, init=icfg))
m = world.maze
occ = np.asarray(m.occ)
lo = np.where(occ, 6.0, -6.0).astype(np.float32)
lo[:, occ.shape[1] // 2:] = 0.0          # right half never explored
cell_px = int(round(m.cell_meters / m.resolution))
cons = _maze_from_wall_tensor(mapping.fit_walls(lo, cell_px=cell_px))
known = _maze_from_wall_tensor(
    mapping.fit_walls(lo, cell_px=cell_px, unexplored_is_wall=False))
ex = np.abs(lo) > 0.5

for seed in (args.seeds or [args.seed]):
  k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
  enc, scans, truth = episodes.simulate_episode_batch(
      k1, m, world.cfg, world.angles, args.ticks, batch=args.batch,
      start_pose=(1.25, 1.25, 0.0))
  if args.replicas > 1:
      # Evidence-selected replicas: run the whole batch K times with
      # different filter keys; per episode keep the replica with the
      # highest accumulated log total weight (the filter's evidence
      # proxy — sum_t log sum_i lik_i).
      bests, confs, evs = [], [], []
      for rrep in range(args.replicas):
          fr, orr = episodes.run_episode_batch(
              jax.random.fold_in(k2, rrep), cons, world.cfg, enc, scans,
              world.angles, known_map=known)
          bests.append(np.asarray(fr.best_pose))
          confs.append(np.asarray(fr.confidence))
          evs.append(np.log(np.maximum(
              np.asarray(orr.total_weight, np.float64), 1e-30)).sum(1))
      evs = np.stack(evs)                      # [K, B]
      pick = np.argmax(evs, axis=0)            # [B]
      best = np.stack([bests[pick[b]][b] for b in range(args.batch)])
      conf = np.asarray([confs[pick[b]][b] for b in range(args.batch)])
  else:
      final, outs = episodes.run_episode_batch(
          k2, cons, world.cfg, enc, scans, world.angles, known_map=known)
      best = np.asarray(final.best_pose)
      conf = np.asarray(final.confidence)
  tpa = np.asarray(truth)
  tp = tpa[:, -1]
  err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
  hit = (best[:, 0] >= 0) & (err < 0.4)
  rows = np.clip((tpa[..., 1] - float(m.origin_y)) / float(m.resolution), 0, ex.shape[0]-1).astype(int)
  cols = np.clip((tpa[..., 0] - float(m.origin_x)) / float(m.resolution), 0, ex.shape[1]-1).astype(int)
  in_cov = ex[rows, cols].mean(axis=1)
  print(f"converged {int(hit.sum())}/{args.batch}  median_err(hit) "
        f"{np.median(err[hit]) if hit.any() else float('nan'):.3f}")
  for b in (range(args.batch) if not args.seeds else []):
      print(f"ep{b:02d} hit={int(hit[b])} conf={conf[b]:.2f} "
            f"err={err[b]:.2f} best=({best[b,0]:.2f},{best[b,1]:.2f}) "
            f"true=({tp[b,0]:.2f},{tp[b,1]:.2f}) in_cov={in_cov[b]:.2f}")
