"""THE single test path: run the pipeline on a bag (or the synthetic rig),
score it, and emit every artifact — the Python-CLI replacement for the
reference's tools/run_and_evaluate_gc.sh (SURVEY.md 2.9):

  results/<stamp>/
    runtime_manifest.json   (startup contract echo)
    trajectory.tum          (/gc/trajectory)
    ground_truth.tum
    diagnostics.npz         (per-scan ScanTape)
    splat_export.npz        (atlas as renderable splats)
    metrics.json            (ATE/RPE, timing)
    dashboard.html          (trajectory + certificate sentinels)
    map_events.jsonl        (per-scan map maintenance event log, spec 5.7.7)

Usage:
  python -m gcslam_tpu.eval.run --scans 160 --out results/run1 [--bag path.db3]
         [--no-map] [--cpu] [--drift 0.05] [--points 8192]
         [--mode absolute|relative]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--scans", type=int, default=160)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--bag", default=None, help="rosbag2 .db3/.mcap path (else synthetic)")
    p.add_argument("--gt", default=None, help="ground-truth TUM file for a bag run")
    p.add_argument("--no-map", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--drift", type=float, default=0.05, help="synthetic odom drift per sqrt(m)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--align", default="initial", choices=["initial", "umeyama", "none"])
    p.add_argument("--mode", default=None, choices=["absolute", "relative"],
                   help="odometry pose factor mode (default: config file else absolute)")
    p.add_argument("--loop", action="store_true",
                   help="produce loop-closure factors (streaming mode)")
    p.add_argument("--chunk", type=int, default=0, metavar="W",
                   help="chunked streaming: lax.scan windows of W scans with "
                        "loop-closure injection at chunk boundaries (the "
                        "live-operation dispatch mode; combines with --loop)")
    p.add_argument("--live-view", default=None, metavar="DIR|spawn",
                   help="live visualization during a streaming run "
                        "(reference rerun_visualizer.py live mode): with the "
                        "rerun SDK installed, 'spawn' pops a viewer; "
                        "otherwise DIR receives a tail-able live.jsonl + "
                        "point/map snapshots")
    p.add_argument("--map-stream", type=int, default=0, metavar="N",
                   help="export incremental map snapshots every N scans "
                        "(streaming mode; the /gc/map live-view analog)")
    p.add_argument("--no-camera", dest="camera", action="store_false",
                   default=None,
                   help="force the camera path OFF (overrides the config; "
                        "rehearsal attribution)")
    p.add_argument("--frontend-set", action="append", default=[],
                   metavar="KEY=VAL",
                   help="override a BagConfig field for bag runs (repeatable; "
                        "JSON values, 'none' -> None). e.g. "
                        "--frontend-set anchor_smoothing_k=1 "
                        "--frontend-set alignment=none")
    p.add_argument("--camera", action="store_true", default=None,
                   help="RGB-D camera + visual frontend (default: config file else off)")
    p.add_argument("--trajectory", default="ramp", choices=["ramp", "circuit"],
                   help="synthetic trajectory shape")
    p.add_argument("--odom-model", default="additive",
                   choices=["additive", "integrated"],
                   help="synthetic wheel-odometry error model: additive "
                        "drift on the true pose, or dead-reckoned "
                        "(integrated) odometry whose heading error bends "
                        "the trajectory — the realistic encoder regime")
    p.add_argument("--config", default=None,
                   help="YAML/JSON PipelineConfig file (configs/gc_default.yaml)")
    p.add_argument("--precision", default=None, choices=["f32", "f64"],
                   help="belief-algebra dtype (docs/ARCHITECTURE.md precision "
                        "policy). Default: GCSLAM_BELIEF_DTYPE env else f64")
    args = p.parse_args(argv)

    if args.precision is not None:
        # The dtype binds when gcslam_tpu is first imported (which `python -m`
        # already did for the package __init__), so re-exec with the env set.
        want = "float32" if args.precision == "f32" else "float64"
        if os.environ.get("GCSLAM_BELIEF_DTYPE", "float64") != want:
            env = dict(os.environ, GCSLAM_BELIEF_DTYPE=want)
            os.execve(sys.executable,
                      [sys.executable, "-m", "gcslam_tpu.eval.run"]
                      + [a for a in (argv or sys.argv[1:])], env)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    # Persistent compilation cache (gcslam_tpu.utils.cache): the
    # full-budget pipeline compile is never paid twice.
    from gcslam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.manifest import write_manifest
    from gcslam_tpu.outputs import dashboard, diagnostics, splat_export, tum
    from gcslam_tpu.eval import ate_rpe

    out_dir = args.out or time.strftime("results/gc_%Y%m%d_%H%M%S")
    os.makedirs(out_dir, exist_ok=True)

    # CLI flags override the config file ONLY when explicitly given (a
    # default --camera/--mode must not silently clobber the YAML contract).
    overrides = {}
    if args.no_map:
        overrides["with_map"] = False
    if args.mode is not None:
        overrides["odom_pose_mode"] = args.mode
    if args.camera is not None:
        overrides["with_camera"] = args.camera
    if args.config:
        from gcslam_tpu.models.config import config_from_file

        cfg = config_from_file(args.config, **overrides)
    else:
        cfg = PipelineConfig(
            atlas_max_tiles=64,
            m_tile=1024,
            m_tile_view=256,
            n_surfel=512,
            surfel_voxel_size_m=0.3,
            **{"odom_pose_mode": "absolute", "with_camera": False, **overrides},
        )
        cfg.validate()
    write_manifest(os.path.join(out_dir, "runtime_manifest.json"), cfg)

    if args.bag:
        from gcslam_tpu.frontend import rosbag

        import dataclasses

        bag_cfg = None
        if args.config:
            bag_cfg = rosbag.bag_config_from_file(args.config)
        if bag_cfg is None:
            bag_cfg = rosbag.BagConfig(n_points=args.points,
                                       with_camera=cfg.with_camera)
        else:
            bag_cfg = dataclasses.replace(bag_cfg, n_points=args.points)
        if (tuple(bag_cfg.T_base_lidar) == (0.0,) * 6
                and tuple(bag_cfg.T_base_imu) == (0.0,) * 6):
            print(
                "WARNING: running a real bag with IDENTITY T_base_lidar/T_base_imu "
                "and imu_accel_scale="
                f"{bag_cfg.imu_accel_scale} — set the `frontend:` section of the "
                "run config (configs/gc_kimera.yaml is the template); wrong "
                "extrinsics silently corrupt every evidence factor.",
                file=sys.stderr,
            )
        if args.camera is not None:
            bag_cfg = dataclasses.replace(bag_cfg, with_camera=args.camera)
        for kv in args.frontend_set:
            key, _, val = kv.partition("=")
            if not _:
                raise SystemExit(f"--frontend-set expects KEY=VAL, got {kv!r}")
            import json as _json

            parsed = None if val.lower() in ("none", "null") else _json.loads(val)
            bag_cfg = dataclasses.replace(bag_cfg, **{key: parsed})
        if cfg.with_camera != bag_cfg.with_camera:
            raise ValueError(
                f"pipeline with_camera={cfg.with_camera} but frontend "
                f"with_camera={bag_cfg.with_camera}; the two must agree"
            )
        batches, gt_poses, gt_times = rosbag.load_bag(args.bag, config=bag_cfg)
        if args.gt:
            from gcslam_tpu.outputs import tum as tum_mod
            from gcslam_tpu.eval import gt_tools

            gt_stamps_raw, gt_raw = tum_mod.read_tum(args.gt)
            scan_stamps = np.asarray([float(b.t_scan) for b in batches])
            gt_tools.check_time_overlap(scan_stamps, gt_stamps_raw)
            # interpolate_gt returns (poses, valid_mask): the mask flags
            # scans outside the GT time range (unpacking only the first
            # element used to hand a TUPLE to compute_ate — crash).
            gt_poses, _gt_valid = gt_tools.interpolate_gt(
                gt_stamps_raw, gt_raw, scan_stamps)
            gt_times = scan_stamps
    else:
        from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

        run = generate(
            SyntheticConfig(
                n_scans=args.scans,
                n_points=args.points,
                odom_drift_pos_per_m=args.drift,
                odom_drift_yaw_per_m=args.drift / 2,
                seed=args.seed,
                trajectory=args.trajectory,
                with_camera=args.camera,
                odom_model=args.odom_model,
            )
        )
        batches, gt_poses, gt_times = run.batches, run.gt_poses, run.gt_times

    from gcslam_tpu.utils.profiling import COUNTERS, device_runtime_cert

    COUNTERS.reset()
    t0 = time.time()
    detector = None
    if args.loop:
        from gcslam_tpu.frontend.loop import LoopDetector

        detector = LoopDetector()
    viewer = None
    if args.live_view:
        from gcslam_tpu.outputs.live_view import LiveViewer

        spawn = args.live_view == "spawn"
        viewer = LiveViewer(
            os.path.join(out_dir, "live") if spawn else args.live_view,
            spawn=spawn,
        )
    if args.chunk > 0:
        state, out = runner.run_chunked(
            batches, cfg, chunk=args.chunk, loop_detector=detector
        )
    elif args.loop or args.map_stream > 0 or viewer is not None:
        state, out = runner.run_stream(
            batches, cfg, loop_detector=detector,
            map_stream_dir=os.path.join(out_dir, "map_stream") if args.map_stream else None,
            map_stream_every=max(args.map_stream, 1),
            status_path=os.path.join(out_dir, "status.jsonl"),
            live_viewer=viewer,
        )
    else:
        state, out = runner.run_bag(batches, cfg)
    poses = COUNTERS.to_host(out.pose)
    wall = time.time() - t0
    stamps = COUNTERS.to_host(out.stamp)

    tum.write_tum(os.path.join(out_dir, "trajectory.tum"), stamps, poses)

    # MEASURED DeviceRuntimeCert (reference certificates.py:298 +
    # runtime_counters.py): every transfer the runner made went through the
    # COUNTERS ledger. jit-cache stability: each jitted entry point must have
    # compiled exactly once for this config (spec 12.9).
    drt = device_runtime_cert()
    drt["run_scan_compiles"] = int(runner.run_scan._cache_size())
    drt["step_compiles"] = int(runner._step_jit._cache_size())
    metrics = {
        "n_scans": int(poses.shape[0]),
        "wall_s_including_compile": round(wall, 2),
        "device": jax.devices()[0].platform,
        "device_runtime": drt,
    }
    if gt_poses is not None:
        tum.write_tum(os.path.join(out_dir, "ground_truth.tum"), gt_times, gt_poses)
        metrics["ate"] = ate_rpe.compute_ate(poses, gt_poses, align=args.align)
        metrics["rpe"] = ate_rpe.compute_rpe(poses, gt_poses)

    diagnostics.save_diagnostics_npz(
        os.path.join(out_dir, "diagnostics.npz"), out.tape, poses, stamps
    )
    diagnostics.save_map_event_log(os.path.join(out_dir, "map_events.jsonl"), out.tape)
    if cfg.with_map:
        n_splats = splat_export.save_splat_export(
            os.path.join(out_dir, "splat_export.npz"), state.atlas
        )
        metrics["n_splats"] = n_splats
    # The dashboard's panels need matplotlib, which is optional.
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if not have_mpl:
        metrics["dashboard"] = "skipped: matplotlib is not installed"
        print(f"eval.run: dashboard {metrics['dashboard']}", file=sys.stderr)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    _write_metrics_csv(os.path.join(out_dir, "metrics.csv"), metrics)
    if have_mpl:
        dashboard.build_dashboard(
            os.path.join(out_dir, "dashboard.html"), out.tape, poses, gt_poses, metrics
        )

    # Post-run invariant audit over the emitted artifacts (the reference
    # gates its results table on an audit pytest, run_and_evaluate_gc.sh:491).
    from gcslam_tpu.eval import audit as audit_mod

    audit = audit_mod.audit_run(out_dir)
    with open(os.path.join(out_dir, "audit.json"), "w") as f:
        json.dump(audit, f, indent=2)

    summary = {
        "out_dir": out_dir,
        "ate_trans_rmse": metrics.get("ate", {}).get("translation", {}).get("rmse"),
        "ate_rot_rmse_deg": metrics.get("ate", {}).get("rotation_deg", {}).get("rmse"),
        "audit_pass": bool(audit.get("all_pass", False)),
    }
    print(json.dumps(summary))
    return metrics


def _write_metrics_csv(path: str, metrics: dict) -> None:
    """Flattened key,value CSV (the reference emits metrics.{txt,csv,json},
    evaluate_slam.py)."""
    rows = []

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}" if prefix else str(k), x)
        elif isinstance(v, (int, float, bool, str)) or v is None:
            rows.append((prefix, v))

    walk("", metrics)
    with open(path, "w") as f:
        f.write("key,value\n")
        for k, v in rows:
            f.write(f"{k},{v}\n")


if __name__ == "__main__":
    main()
