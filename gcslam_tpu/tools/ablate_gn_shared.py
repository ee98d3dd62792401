"""map_gn_shared ablation at production budgets: shared-GN (one alignment
chain per scan, hypothesis 0's predicted pose)
vs per-hypothesis GN (reference backend_node.py:2036 semantics) on the
HARD regime — circuit trajectory + dead-reckoned (integrated-drift)
odometry, where the map must supply the correction authority.

  python -m gcslam_tpu.tools.ablate_gn_shared [--scans 80] [--json PATH]

Emits one JSON with ATE + latency per mode; the committed numbers back the
map_gn_shared default in docs/ARCHITECTURE.md.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=int, default=80)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    import os
    import sys as _sys

    if os.environ.get("GCSLAM_BELIEF_DTYPE", "float64") != "float32":
        os.execve(_sys.executable,
                  [_sys.executable, "-m", "gcslam_tpu.tools.ablate_gn_shared"]
                  + (argv if argv is not None else _sys.argv[1:]),
                  dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"))

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from gcslam_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()

    import dataclasses
    import numpy as np
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_step import init_state
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.eval import ate_rpe

    # Hard regime: dead-reckoned odometry drifts without bound; ATE is then a
    # direct read of the map branch's correction authority.
    run = generate(SyntheticConfig(
        n_scans=args.scans, n_points=PipelineConfig().n_points_cap,
        trajectory="circuit", odom_model="integrated",
        odom_drift_pos_per_m=0.05, odom_drift_yaw_per_m=0.02,
    ))
    stacked = stack_scan_batches(run.batches)

    modes = {
        "shared": {},  # production default: map_gn_shared=True
        "per_hyp_gn": {"map_gn_shared": False},
        "no_share": {"map_gn_shared": False, "map_share_extraction": False},
    }
    out = {"device": jax.devices()[0].platform, "scans": args.scans,
           "regime": "circuit + dead-reckoned odom (0.05 m/m, 0.02 rad/m)"}
    for name, over in modes.items():
        cfg = dataclasses.replace(PipelineConfig(), **over)
        cfg.validate()
        fn = jax.jit(lambda s, b, cfg=cfg: runner.run_scan(s, b, cfg))
        t0 = time.time()
        _, o = fn(init_state(cfg), stacked)
        _ = float(np.asarray(o.pose)[-1, 0])
        compile_s = time.time() - t0
        t0 = time.time()
        _, o = fn(init_state(cfg), stacked)
        poses = np.asarray(o.pose)
        ms = (time.time() - t0) / args.scans * 1e3
        ate = ate_rpe.compute_ate(poses, run.gt_poses, align="initial")
        out[name] = {
            "compile_s": round(compile_s, 1),
            "ms_per_scan": round(ms, 3),
            "ate_trans_rmse_m": round(ate["translation"]["rmse"], 4),
            "ate_rot_rmse_deg": round(ate["rotation_deg"]["rmse"], 3),
            "finite": bool(np.all(np.isfinite(poses))),
        }
        print(name, json.dumps(out[name]), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
