"""Run the benchmark matrix and write BENCH_DETAILS.md.

Covers the BASELINE.md configs on the accelerator: reference-semantics fixed
march, exact analytic, full-fidelity 360-beam, and particle scaling.

Run: python tools/bench_matrix.py
"""
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.join(osp.dirname(osp.abspath(__file__)), "..")

CONFIGS = [
    ("reference semantics, 1M x 34 (headline)", ["--particles", "1000000", "--beams", "34", "--iters", "30"]),
    ("reference semantics, 1M x 12", ["--particles", "1000000", "--beams", "12", "--iters", "30"]),
    ("exact analytic ray cast, 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "30", "--ray-mode", "analytic"]),
    ("scaling: 4M x 34", ["--particles", "4000000", "--beams", "34", "--iters", "10"]),
    ("full fidelity: 10k x 360 analytic", ["--particles", "10000", "--beams", "360", "--iters", "30", "--ray-mode", "analytic"]),
    ("reference-count replay: 1500 x 34", ["--particles", "1500", "--beams", "34", "--iters", "50"]),
    ("log-combine, 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "30", "--beam-combine", "log"]),
    ("multinomial (parity path), 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "10", "--resample", "multinomial"]),
]


def main() -> None:
    rows = []
    for name, args in CONFIGS:
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, osp.join(ROOT, "bench.py"), *args],
            capture_output=True, text=True, timeout=1200)
        line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() \
            else f"FAILED: {out.stderr[-200:]}"
        rows.append((name, " ".join(args), line, round(time.time() - t0, 1)))
        print(f"{name}: {line}", flush=True)
    path = osp.join(ROOT, "BENCH_DETAILS.md")
    # Preserve everything after the matrix table (sweep results, donation
    # notes, ...) across refreshes: sections start at the first "## ".
    extra = ""
    try:
        with open(path) as f:
            old = f.read()
        cut = old.find("\n## ")
        if cut >= 0:
            extra = old[cut:]
    except FileNotFoundError:
        pass
    with open(path, "w") as f:
        import jax

        dev = jax.devices()[0]
        f.write(f"# Benchmark matrix (one {dev.device_kind})\n\n")
        f.write("Full MCL step (motion + likelihood + adaptive resampling "
                "+ k-means confidence).\n\n")
        f.write("| Config | Args | Result | Wall (s, incl. compile) |\n")
        f.write("|---|---|---|---|\n")
        for name, args, line, wall in rows:
            f.write(f"| {name} | `{args}` | `{line}` | {wall} |\n")
        f.write(extra)
    print("wrote BENCH_DETAILS.md")


if __name__ == "__main__":
    main()
