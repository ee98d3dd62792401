"""Benchmark: steady-state per-scan latency of the full GC pipeline at TRUE
PRODUCTION BUDGETS on one GPU, gated on accuracy. Refuses to run without a
GPU: a CPU time is not a device number.

Reference baseline: ~1.5 s/scan (BASELINE.md: 1-2 s/scan on a dev GPU);
north star <= 5 ms/scan (BASELINE.json).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where value
is the whole-bag replay ms/scan and vs_baseline = reference_ms / ours.
Stderr carries the full honest breakdown: replay / chunked / per-step stream
latencies, the camera-path variant, compile times, the exact budgets run,
and the accuracy-gate numbers. Exits non-zero if accuracy regresses —
a speed number with no accuracy gate invites silent regressions.

Budgets (PipelineConfig defaults == gcslam_tpu/constants.py production
values): K_HYP=4, 8192 points, 1024 surfels + 512 camera feats, atlas
128 tiles x 2048 slots, view 1024/tile x 7 stencil tiles, voxel 0.1 m,
Sinkhorn K=50, IMU window 512.
"""

import json
import os
import sys
import time

REFERENCE_MS_PER_SCAN = 1500.0

# Accuracy gate (committed thresholds; see `gate` in main()). Values hold
# 2x headroom over measured results at these budgets — regression beyond
# them means the speed number is measuring a broken pipeline.
GATE_ATE_TRANS_RMSE_M = 0.30
GATE_ATE_ROT_RMSE_DEG = 4.0
GATE_CHUNK_ATE_TRANS_RMSE_M = 0.30
# Camera path is first-class: scored on ATE like the flagship, not
# finiteness-only.
GATE_CAM_ATE_TRANS_RMSE_M = 0.30
GATE_CAM_ATE_ROT_RMSE_DEG = 4.0

# Production precision: f32 belief algebra (absolute stamps stay f64 via
# TIME_DTYPE) at accuracy gated by tests/test_precision.py; it is also the
# precision the fused Sinkhorn kernel runs in. Override with
# GCSLAM_BELIEF_DTYPE=float64 for the reference-parity mode.
os.environ.setdefault("GCSLAM_BELIEF_DTYPE", "float32")

N_SCANS = 50
N_SCANS_CAM = 50
CHUNK = 10


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX's first device is {dev.platform!r}); "
                 "the benchmark times the device and has no CPU fallback")

    import numpy as np
    import gcslam_tpu  # noqa: F401 (x64 on)
    from gcslam_tpu.utils.cache import enable_compile_cache

    # the full-pipeline compile is never paid twice
    enable_compile_cache()

    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_step import init_state
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.eval import ate_rpe

    # FULL production budgets: PipelineConfig defaults (constants.py:143-182).
    cfg = PipelineConfig()
    cfg.validate()
    run = generate(SyntheticConfig(n_scans=N_SCANS, n_points=cfg.n_points_cap))

    report: dict = {"budgets": {
        "k_hyp": cfg.k_hyp, "n_points": cfg.n_points_cap, "n_surfel": cfg.n_surfel,
        "n_feat": cfg.n_feat, "atlas": f"{cfg.atlas_max_tiles}x{cfg.m_tile}",
        "m_tile_view": cfg.m_tile_view, "voxel_m": cfg.surfel_voxel_size_m,
        "k_sinkhorn": cfg.k_sinkhorn, "imu_len": cfg.max_imu_len,
        "k_shortlist": cfg.k_shortlist,
    }}

    # Every timed region ends in block_until_ready: JAX returns before the
    # device finishes, so a timing without it measures the enqueue.
    _sync = jax.block_until_ready

    # --- 1. whole-bag replay (ONE dispatch, production batched-replay) ----
    batches = stack_scan_batches(run.batches)
    state0 = init_state(cfg)
    scan_fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg))
    t0 = time.time()
    state, out = scan_fn(state0, batches)
    _sync(out.pose)
    report["compile_replay_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    state, out = scan_fn(state0, batches)
    _sync(out.pose)
    replay_ms = (time.time() - t0) / N_SCANS * 1000.0
    report["replay_ms"] = round(replay_ms, 4)

    poses = np.asarray(out.pose)
    report["finite"] = bool(np.all(np.isfinite(poses)))

    # --- accuracy gate on the replay run ----------------------------------
    ate = ate_rpe.compute_ate(poses, run.gt_poses, align="initial")
    report["ate_trans_rmse_m"] = round(ate["translation"]["rmse"], 4)
    report["ate_rot_rmse_deg"] = round(ate["rotation_deg"]["rmse"], 3)

    # --- 2. chunked streaming (the live-operation mode) -------------------
    # Steady state takes the pre-staged (device-resident) batch tensor —
    # a live frontend stages scans into a ring buffer concurrently with the
    # previous chunk's compute; that staging cost is measured separately
    # below as chunk_stage_ms (host stack of one bag / N_SCANS).
    t0 = time.time()
    state_c, out_c = runner.run_chunked(batches, cfg, chunk=CHUNK)
    _sync(out_c.pose)
    report["compile_chunked_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    state_c, out_c = runner.run_chunked(batches, cfg, chunk=CHUNK)
    _sync(out_c.pose)
    chunk_ms = (time.time() - t0) / N_SCANS * 1000.0
    report["chunked_ms"] = round(chunk_ms, 4)
    t0 = time.time()
    _sync(stack_scan_batches(run.batches).points)
    report["chunk_stage_ms"] = round((time.time() - t0) / N_SCANS * 1000.0, 4)
    ate_c = ate_rpe.compute_ate(np.asarray(out_c.pose), run.gt_poses, align="initial")
    report["chunked_ate_trans_rmse_m"] = round(ate_c["translation"]["rmse"], 4)

    # --- 2b. OVERLAPPED streaming: stage chunk N+1 while chunk N computes —
    # the wall-clock a live robot actually sees (reference async LiDAR
    # worker, backend_node.py:1340-1388). Staging is DEVICE-SIDE
    # (runner.make_device_stager): per scan, one small h2d + one jitted
    # donated row write into the device-resident window, so a producer
    # thread does not contend with the dispatch thread for the GIL. One
    # (CHUNK,)-shaped program per chunk; staging is hidden iff
    # stream_overlapped_ms ~= chunked_ms.
    import queue as _queue
    import threading

    chunk_fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg))
    empty_win, stage_one = runner.make_device_stager(run.batches[0], CHUNK)
    import jax.numpy as jnp

    make_empty = jax.jit(
        lambda: jax.tree_util.tree_map(jnp.zeros_like, empty_win))

    # warm all three programs
    win0 = make_empty()
    for k in range(CHUNK):
        win0 = stage_one(win0, run.batches[k], k)
    t0 = time.time()
    st_w, out_w = chunk_fn(init_state(cfg), win0)
    _sync(out_w.pose)
    report["compile_overlap_s"] = round(time.time() - t0, 1)

    n_chunks = N_SCANS // CHUNK
    staged: _queue.Queue = _queue.Queue(maxsize=2)

    def _producer():
        for c in range(n_chunks):
            buf = make_empty()
            for k in range(CHUNK):
                buf = stage_one(buf, run.batches[c * CHUNK + k], k)
            staged.put(buf)
        staged.put(None)

    state_o = init_state(cfg)
    prod = threading.Thread(target=_producer, daemon=True)
    t0 = time.time()
    prod.start()
    while True:
        w = staged.get()
        if w is None:
            break
        state_o, out_o = chunk_fn(state_o, w)
    _sync(out_o.pose)
    overlapped_ms = (time.time() - t0) / N_SCANS * 1000.0
    report["stream_overlapped_ms"] = round(overlapped_ms, 4)

    # --- 3. per-step host loop (worst-case dispatch bound) ----------------
    state_s = init_state(cfg)
    for b in run.batches[:3]:
        state_s, out_s = runner._step_jit(state_s, b, cfg)
    _sync(out_s.pose)
    t0 = time.time()
    for b in run.batches[3:23]:
        state_s, out_s = runner._step_jit(state_s, b, cfg)
    _sync(out_s.pose)
    report["stream_ms"] = round((time.time() - t0) / 20 * 1000.0, 3)

    # --- 4. camera-path variant (with_camera=True) --------------------------
    cfg_cam = PipelineConfig(with_camera=True)
    cfg_cam.validate()
    run_cam = generate(SyntheticConfig(
        n_scans=N_SCANS_CAM, n_points=cfg.n_points_cap, with_camera=True))
    batches_cam = stack_scan_batches(run_cam.batches)
    cam_fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg_cam))
    t0 = time.time()
    _, out_cam = cam_fn(init_state(cfg_cam), batches_cam)
    _sync(out_cam.pose)
    report["compile_camera_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    _, out_cam = cam_fn(init_state(cfg_cam), batches_cam)
    _sync(out_cam.pose)
    report["camera_replay_ms"] = round((time.time() - t0) / N_SCANS_CAM * 1000.0, 4)
    poses_cam = np.asarray(out_cam.pose)
    report["camera_finite"] = bool(np.all(np.isfinite(poses_cam)))
    ate_cam = ate_rpe.compute_ate(poses_cam, run_cam.gt_poses, align="initial")
    report["camera_ate_trans_rmse_m"] = round(ate_cam["translation"]["rmse"], 4)
    report["camera_ate_rot_rmse_deg"] = round(ate_cam["rotation_deg"]["rmse"], 3)

    # --- gate + emit -------------------------------------------------------
    failures = []
    if not report["finite"]:
        failures.append("non-finite poses")
    if report["ate_trans_rmse_m"] > GATE_ATE_TRANS_RMSE_M:
        failures.append(f"ATE trans {report['ate_trans_rmse_m']} > {GATE_ATE_TRANS_RMSE_M}")
    if report["ate_rot_rmse_deg"] > GATE_ATE_ROT_RMSE_DEG:
        failures.append(f"ATE rot {report['ate_rot_rmse_deg']} > {GATE_ATE_ROT_RMSE_DEG}")
    if report["chunked_ate_trans_rmse_m"] > GATE_CHUNK_ATE_TRANS_RMSE_M:
        failures.append(f"chunked ATE {report['chunked_ate_trans_rmse_m']} "
                        f"> {GATE_CHUNK_ATE_TRANS_RMSE_M}")
    if not report["camera_finite"]:
        failures.append("camera path non-finite")
    if report["camera_ate_trans_rmse_m"] > GATE_CAM_ATE_TRANS_RMSE_M:
        failures.append(f"camera ATE trans {report['camera_ate_trans_rmse_m']} "
                        f"> {GATE_CAM_ATE_TRANS_RMSE_M}")
    if report["camera_ate_rot_rmse_deg"] > GATE_CAM_ATE_ROT_RMSE_DEG:
        failures.append(f"camera ATE rot {report['camera_ate_rot_rmse_deg']} "
                        f"> {GATE_CAM_ATE_ROT_RMSE_DEG}")

    result = {
        "metric": "ms_per_scan_full_pipeline",
        "value": round(replay_ms, 4),
        "unit": "ms/scan",
        "vs_baseline": round(REFERENCE_MS_PER_SCAN / max(replay_ms, 1e-9), 1),
    }
    print(json.dumps(result))
    from gcslam_tpu.utils.xla import BELIEF_DTYPE, jnp

    report["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    report["belief_dtype"] = str(jnp.dtype(BELIEF_DTYPE))
    report["gate"] = "PASS" if not failures else "FAIL: " + "; ".join(failures)
    print("# " + json.dumps(report), file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
