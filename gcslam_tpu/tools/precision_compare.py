"""f32-vs-f64 belief-precision comparison on the device: the reference
contract is float64 end-to-end (common/jax_init.py:24); this framework's
production mode is f32-belief. This tool runs the SAME 50-scan
production-budget replay under both dtypes and reports the ATE +
certificate-field deltas that back the precision policy.

  python -m gcslam_tpu.tools.precision_compare [--scans 50] [--json PATH]

Each dtype runs in its own child process (BELIEF_DTYPE binds at package
import); the parent never imports JAX, so one process holds the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def run_one(dtype: str, scans: int) -> dict:
    import jax

    from gcslam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_step import init_state
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.eval import ate_rpe
    from gcslam_tpu.utils.xla import BELIEF_DTYPE, jnp

    assert str(jnp.dtype(BELIEF_DTYPE)) == dtype, (BELIEF_DTYPE, dtype)

    cfg = PipelineConfig()
    run = generate(SyntheticConfig(n_scans=scans, n_points=cfg.n_points_cap))
    stacked = stack_scan_batches(run.batches)
    fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg))
    t0 = time.time()
    _, out = fn(init_state(cfg), stacked)
    _ = float(np.asarray(out.pose)[-1, 0])
    compile_s = time.time() - t0
    t0 = time.time()
    _, out = fn(init_state(cfg), stacked)
    poses = np.asarray(out.pose)
    ms = (time.time() - t0) / scans * 1e3
    ate = ate_rpe.compute_ate(poses, run.gt_poses, align="initial")
    tape = out.tape
    g = lambda x: np.asarray(x, dtype=np.float64)
    return {
        "belief_dtype": dtype,
        "device": jax.devices()[0].platform,
        "compile_s": round(compile_s, 1),
        "ms_per_scan": round(ms, 3),
        "ate_trans_rmse_m": round(ate["translation"]["rmse"], 6),
        "ate_rot_rmse_deg": round(ate["rotation_deg"]["rmse"], 4),
        "eigmin_pose6_min": float(g(tape.eigmin_pose6).min()),
        "eigmin_pose6_mean": float(g(tape.eigmin_pose6).mean()),
        "cond_pose6_max": float(g(tape.cond_pose6).max()),
        "cond_pose6_mean": float(g(tape.cond_pose6).mean()),
        "psd_projection_delta_max": float(g(tape.influence_psd_projection_delta).max()),
        "psd_projection_delta_mean": float(g(tape.influence_psd_projection_delta).mean()),
        "trigger_mag_total": float(g(tape.total_trigger_magnitude).sum()),
        "finite": bool(np.all(np.isfinite(poses))),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=int, default=50)
    p.add_argument("--json", default=None)
    p.add_argument("--dtype", default=None, help=argparse.SUPPRESS)  # child mode
    args = p.parse_args(argv)

    if args.dtype:
        cur = os.environ.get("GCSLAM_BELIEF_DTYPE", "float64")
        if cur != args.dtype:
            os.execve(sys.executable,
                      [sys.executable, "-m", "gcslam_tpu.tools.precision_compare",
                       "--dtype", args.dtype, "--scans", str(args.scans)],
                      dict(os.environ, GCSLAM_BELIEF_DTYPE=args.dtype))
        print(json.dumps(run_one(args.dtype, args.scans)), flush=True)
        return {}

    out = {}
    for dtype in ("float32", "float64"):
        r = subprocess.run(
            [sys.executable, "-m", "gcslam_tpu.tools.precision_compare",
             "--dtype", dtype, "--scans", str(args.scans)],
            capture_output=True, text=True,
            env=dict(os.environ, GCSLAM_BELIEF_DTYPE=dtype),
        )
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        if r.returncode != 0 or not lines:
            out[dtype] = {"error": (r.stderr or r.stdout)[-500:]}
        else:
            out[dtype] = json.loads(lines[-1])
        print(dtype, json.dumps(out[dtype]), flush=True)

    if "error" not in out.get("float32", {}) and "error" not in out.get("float64", {}):
        f32, f64 = out["float32"], out["float64"]
        out["delta"] = {
            "ate_trans_rmse_m": round(f32["ate_trans_rmse_m"] - f64["ate_trans_rmse_m"], 6),
            "ate_rot_rmse_deg": round(f32["ate_rot_rmse_deg"] - f64["ate_rot_rmse_deg"], 4),
            "compile_ratio": round(f64["compile_s"] / max(f32["compile_s"], 1e-9), 1),
            "latency_ratio": round(f64["ms_per_scan"] / max(f32["ms_per_scan"], 1e-9), 1),
        }
        print("delta", json.dumps(out["delta"]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
