"""Measure the WARMED cold start: time from process start to first pose in
a FRESH process after tools/warm_cache populated the persistent cache.

The reference pays ~30 s of first-scan JIT every boot
(docs/PIPELINE_DESIGN_GAPS.md:209). Here a deploy warms the cache once
(tools/warm_cache); every subsequent boot deserializes the compiled
executables instead of recompiling. This tool spawns the fresh process and
records its milestones:

  python -m gcslam_tpu.tools.cold_start [--json results/coldstart.json]
         [--skip-warm] [--cpu]

Milestones reported by the child (all seconds since process start):
  import_done  — jax + gcslam_tpu imported, backend initialized
  data_ready   — one synthetic scan staged
  first_pose_s — the per-scan streaming step compiled (cache hit) AND its
                 first real pose read back (the live-robot boot metric)
  chunk_pose_s — additionally, the chunk-of-10 program's first output
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_CHILD = r"""
import json, os, time
T0 = time.time()
import jax
from gcslam_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
if os.environ.get("GCSLAM_COLD_CPU") == "1":
    jax.config.update("jax_platforms", "cpu")
import numpy as np
import gcslam_tpu
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.models.scan_step import init_state
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
m = {"import_done": round(time.time() - T0, 2)}
cfg = PipelineConfig()
cfg.validate()
run = generate(SyntheticConfig(n_scans=10, n_points=cfg.n_points_cap))
m["data_ready"] = round(time.time() - T0, 2)
state = init_state(cfg)
state, out = runner._step_jit(state, run.batches[0], cfg)
_ = float(np.asarray(out.pose)[0])
m["first_pose_s"] = round(time.time() - T0, 2)
from gcslam_tpu.models.scan_io import stack_scan_batches
win = jax.device_put(stack_scan_batches(run.batches))
state2, out2 = runner.run_scan(init_state(cfg), win, cfg)
_ = float(np.asarray(out2.pose).ravel()[0])
m["chunk_pose_s"] = round(time.time() - T0, 2)
print("CHILD_JSON " + json.dumps(m))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/coldstart.json")
    ap.add_argument("--skip-warm", action="store_true",
                    help="assume tools/warm_cache already ran")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    report = {}
    if not args.skip_warm:
        t0 = time.time()
        cmd = [sys.executable, "-m", "gcslam_tpu.tools.warm_cache",
               "--scans", "10"]
        if args.cpu:
            cmd.append("--cpu")
        r = subprocess.run(cmd, cwd=repo)
        report["warm_cache_s"] = round(time.time() - t0, 1)
        report["warm_cache_rc"] = r.returncode

    env = dict(os.environ, GCSLAM_BELIEF_DTYPE="float32")
    if args.cpu:
        env["GCSLAM_COLD_CPU"] = "1"
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=1800)
    wall = round(time.time() - t0, 2)
    child = {}
    for line in r.stdout.splitlines():
        if line.startswith("CHILD_JSON "):
            child = json.loads(line[len("CHILD_JSON "):])
    report.update(child)
    report["fresh_process_wall_s"] = wall
    report["rc"] = r.returncode
    if r.returncode != 0:
        report["stderr_tail"] = r.stderr[-500:]
    out = json.dumps(report, indent=1)
    print(out)
    path = os.path.join(repo, args.json)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(out + "\n")
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
