"""Generate the canonical recorded replay fixture (BASELINE config 1).

Writes montecarlolocalisation/data/replay_6x6.npz: a 240-tick wander on
the default 6x6 maze with 36 beams, encoders + noisy scans + ground truth.
Deterministic (fixed seeds) so the fixture is reproducible from source.

Run: python tools/generate_fixture.py
"""
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

os.environ.setdefault("XLA_FLAGS", "")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from montecarlolocalisation.config import FilterConfig, SensorModelConfig
from montecarlolocalisation.io import EpisodeLog
from montecarlolocalisation.maps import from_map_file
from montecarlolocalisation.sim import robot

PKG = osp.join(osp.dirname(osp.abspath(__file__)), "..",
               "montecarlolocalisation")
OUT = osp.join(PKG, "data", "replay_6x6.npz")


def main() -> None:
    maze = from_map_file(osp.join(PKG, "maps", "default_map.txt"))
    cfg = FilterConfig(sensor=SensorModelConfig(ray_mode="dda"))
    angles = np.deg2rad(np.linspace(-118.0, 118.0, 36)).astype(np.float32)
    enc, ranges, poses = robot.generate_wander_episode(
        jax.random.PRNGKey(7), maze, cfg, angles, num_ticks=240,
        start_pose=(2.05, 2.05, 0.0))
    os.makedirs(osp.dirname(OUT), exist_ok=True)
    EpisodeLog(
        encoders=np.asarray(enc),
        scan_ranges=np.asarray(ranges),
        scan_angles=angles,
        true_poses=np.asarray(poses),
        meta=dict(map="default_map.txt", seed=7, ticks=240, beams=36,
                  scan_noise=0.02, start=[2.05, 2.05, 0.0],
                  generator="tools/generate_fixture.py"),
    ).save(OUT)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
