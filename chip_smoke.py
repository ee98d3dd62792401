"""Smoke test of gcslam_tpu on one NVIDIA GPU at production budgets.

Drives the main path once through the entry points a user calls, on the
seeded synthetic ramp world (frontend/synthetic.py), at the PipelineConfig()
budgets bench.py runs (K_HYP=4, 8192 points, 1024 surfels + 512 camera
features, atlas 128 tiles x 2048 slots, view 1024 slots x 7 tiles,
K_SINKHORN=50, IMU window 512):

  kernel   the Sinkhorn kernel compiled for the card at N=1024 and N=1536
           (K=8, 50 iterations), alone and under the K_HYP=4 vmap, against
           the XLA loop (association._sinkhorn_unbalanced, full-f32 matmuls);
  compile  the four programs below compiled at once into the compile cache;
  main     50-scan replay (runner.run_bag) twice, chunked streaming
           (runner.run_chunked, chunk=10), a few per-scan steps
           (runner._step_jit); gated on finiteness and bench.py's ATE gates;
  camera   the same replay with the camera path on the camera world;
  cli      gcslam_tpu.eval.run.main on a JSON config at the same budgets,
           which must pass its artifact audit.

  python chip_smoke.py [--precision f32|f64]     # one GPU, every phase
  python chip_smoke.py --four                    # four GPUs: mesh families only

Exits non-zero, printing no result, when JAX finds no GPU. The last line of
stdout is one JSON object: {"ok": true, "device": {"platform", "kind",
"count"}}. Times are information, labelled with the card; they are not gates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

# Kernel-vs-XLA tolerance: both compute in f32 with libdevice exp/pow and
# sum the same terms in different orders (an (8, N) tile reduction vs a
# matmul); 50 multiplicative iterations grow last-bit differences to a few
# 1e-6 relative on the larger entries.
KERNEL_RTOL = 1e-4
KERNEL_ATOL = 1e-7
# Mesh families vs one device on GPUs: sharding changes reduction order (NCCL
# all-reduces, partitioned scatters), and the filter amplifies last-bit
# differences over scans; few-scan pose agreement far inside the ATE gates.
FOUR_TOL = 1e-3
N_SCANS = 50
CHUNK = 10
N_STEPS = 3
FOUR_SCANS = 5


def _say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "unavailable"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unavailable"


def phase_kernel(widths=(1024, 1536), k: int = 8, n_iters: int = 50,
                 n_hyp: int = 4, interpret: bool = False) -> dict:
    """Kernel vs the XLA loop, alone and under the hypothesis vmap."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gcslam_tpu.ops.association import _sinkhorn_unbalanced
    from gcslam_tpu.ops.sinkhorn_pallas import sinkhorn_unbalanced_pallas

    eps, tau_a, tau_b = 0.05, 1.0, 1.0
    rep = {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "cases": {}, "ok": True}
    rng = np.random.default_rng(0)
    for n in widths:
        C = rng.uniform(0.0, 5.0, size=(n_hyp, n, k)).astype(np.float32)
        valid = rng.uniform(size=n) > 0.33
        a = (valid / max(valid.sum(), 1)).astype(np.float32)
        b = np.full((k,), 1.0 / k, np.float32)
        C, a, b = jnp.asarray(C), jnp.asarray(a), jnp.asarray(b)
        ref = jax.jit(jax.vmap(lambda c: _sinkhorn_unbalanced(
            c, a, b, eps, tau_a, tau_b, n_iters)))(C)
        one = sinkhorn_unbalanced_pallas(C[0], a, b, eps, tau_a, tau_b, n_iters,
                                         interpret=interpret)
        vm = jax.jit(jax.vmap(lambda c: sinkhorn_unbalanced_pallas(
            c, a, b, eps, tau_a, tau_b, n_iters, interpret=interpret)))(C)
        ref = np.asarray(ref)
        for name, got, want in (("alone", np.asarray(one), ref[0]),
                                (f"vmap{n_hyp}", np.asarray(vm), ref)):
            err = np.abs(got - want)
            case = {
                "max_abs": float(err.max()),
                "max_rel": float((err / np.maximum(np.abs(want), 1e-30)).max()),
                "ok": bool(np.all(np.isfinite(got))
                           and np.all(err <= KERNEL_ATOL + KERNEL_RTOL * np.abs(want))),
            }
            rep["cases"][f"N={n} {name}"] = case
            rep["ok"] &= case["ok"]
    return rep


def _ate(poses, gt) -> dict:
    from gcslam_tpu.eval import ate_rpe

    ate = ate_rpe.compute_ate(poses, gt, align="initial")
    return {"trans_m": ate["translation"]["rmse"], "rot_deg": ate["rotation_deg"]["rmse"]}


def _gate(name: str, poses, ate: dict, max_trans: float, max_rot: float) -> list:
    import numpy as np

    fails = []
    if not np.all(np.isfinite(poses)):
        fails.append(f"{name}: non-finite poses")
    if not ate["trans_m"] <= max_trans:
        fails.append(f"{name}: ATE trans {ate['trans_m']} > {max_trans}")
    if not ate["rot_deg"] <= max_rot:
        fails.append(f"{name}: ATE rot {ate['rot_deg']} > {max_rot}")
    return fails


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def precompile(cfg, cfg_cam, n_scans: int = N_SCANS, n_points: int | None = None,
               chunk: int = CHUNK) -> dict:
    """Compile every program the one-GPU phases run (replay, chunked window,
    per-scan step, camera replay) at once, one thread each, into the
    persistent compile cache; each phase's first call then loads its program
    instead of compiling it. The arguments mirror what runner.run_bag /
    run_chunked / _step_jit pass. Returns name -> seconds and the wall time
    of the whole (the compiles run concurrently, so each includes
    contention)."""
    import concurrent.futures as cf
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gcslam_tpu.frontend.synthetic import SyntheticConfig, generate
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.models.scan_step import init_state

    n_points = n_points or cfg.n_points_cap
    run = generate(SyntheticConfig(n_scans=n_scans, n_points=n_points))
    run_cam = generate(SyntheticConfig(n_scans=n_scans, n_points=n_points, with_camera=True))
    stacked = stack_scan_batches(run.batches)
    n_full = n_scans // chunk * chunk
    windows = jax.tree_util.tree_map(
        lambda x: x[:n_full].reshape((n_scans // chunk, chunk) + x.shape[1:]), stacked)
    lowered = {
        "replay": runner.run_scan.lower(init_state(cfg), jax.device_put(stacked), cfg),
        "chunked": runner._chunk_jit.lower(
            init_state(cfg), jax.device_put(windows), 0, jnp.asarray(np.zeros(6)),
            jnp.asarray(np.eye(6)), jnp.asarray(0.0), cfg),
        "step": runner._step_jit.lower(init_state(cfg), run.batches[0], cfg),
        "camera_replay": runner.run_scan.lower(
            init_state(cfg_cam), jax.device_put(stack_scan_batches(run_cam.batches)), cfg_cam),
    }

    def compile_one(item):
        t0 = time.perf_counter()
        item[1].compile()
        return item[0], time.perf_counter() - t0

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(lowered)) as ex:
        rep = dict(ex.map(compile_one, lowered.items()))
    rep["wall"] = time.perf_counter() - t0
    return rep


def phase_main(cfg, n_scans: int = N_SCANS, n_points: int | None = None,
               chunk: int = CHUNK, n_steps: int = N_STEPS) -> dict:
    """Replay (twice), chunked streaming and per-scan steps, gated.
    chunk=0 / n_steps=0 leave the chunked / per-scan programs out. The
    first_*_s times include compilation unless `precompile` ran."""
    import numpy as np
    import jax
    from bench import (GATE_ATE_ROT_RMSE_DEG, GATE_ATE_TRANS_RMSE_M,
                       GATE_CHUNK_ATE_TRANS_RMSE_M)
    from gcslam_tpu.frontend.synthetic import SyntheticConfig, generate
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.models.scan_step import init_state

    run = generate(SyntheticConfig(n_scans=n_scans, n_points=n_points or cfg.n_points_cap))
    rep: dict = {}
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg)
    poses1 = np.asarray(out.pose)
    rep["first_replay_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg)
    jax.block_until_ready(out.pose)
    # run_bag: host stacking + h2d + fresh state + the replay program
    rep["run_bag_ms_per_scan"] = (time.perf_counter() - t0) / n_scans * 1e3
    poses = np.asarray(out.pose)
    staged = jax.device_put(stack_scan_batches(run.batches))
    state0 = jax.block_until_ready(init_state(cfg))
    t0 = time.perf_counter()
    jax.block_until_ready(runner.run_scan(state0, staged, cfg))
    # the replay program alone, on device-resident scans (bench.py's replay)
    rep["replay_ms_per_scan"] = (time.perf_counter() - t0) / n_scans * 1e3
    rep["replay_max_abs_dpose_run1_vs_run2"] = float(np.abs(poses - poses1).max())
    rep["ate"] = _ate(poses, run.gt_poses)
    fails = _gate("replay", poses, rep["ate"], GATE_ATE_TRANS_RMSE_M, GATE_ATE_ROT_RMSE_DEG)

    if chunk:
        t0 = time.perf_counter()
        _, out_c = runner.run_chunked(run.batches, cfg, chunk=chunk)
        poses_c = np.asarray(out_c.pose)
        rep["first_chunked_s"] = time.perf_counter() - t0
        rep["chunked_ate"] = _ate(poses_c, run.gt_poses)
        fails += _gate("chunked", poses_c, rep["chunked_ate"],
                       GATE_CHUNK_ATE_TRANS_RMSE_M, GATE_ATE_ROT_RMSE_DEG)
    if n_steps:
        state = init_state(cfg)
        t0 = time.perf_counter()
        for b in run.batches[:n_steps]:
            state, out_s = runner._step_jit(state, b, cfg)
        steps = np.asarray(out_s.pose)
        rep["first_steps_s"] = time.perf_counter() - t0
        if not np.all(np.isfinite(steps)):
            fails.append("steps: non-finite poses")
        rep["step_vs_replay_max_abs_dpose"] = float(np.abs(steps - poses[n_steps - 1]).max())
    rep["peak_bytes_in_use"] = _peak_bytes()
    rep["failures"] = fails
    return rep


def phase_camera(cfg, n_scans: int = N_SCANS, n_points: int | None = None) -> dict:
    """The camera path (with_camera=True) on the camera world, gated."""
    import numpy as np
    from bench import GATE_CAM_ATE_ROT_RMSE_DEG, GATE_CAM_ATE_TRANS_RMSE_M
    from gcslam_tpu.frontend.synthetic import SyntheticConfig, generate
    from gcslam_tpu.models import runner

    run = generate(SyntheticConfig(n_scans=n_scans, n_points=n_points or cfg.n_points_cap,
                                   with_camera=True))
    rep: dict = {}
    t0 = time.perf_counter()
    _, out = runner.run_bag(run.batches, cfg)
    poses = np.asarray(out.pose)
    rep["first_replay_s"] = time.perf_counter() - t0
    rep["ate"] = _ate(poses, run.gt_poses)
    rep["failures"] = _gate("camera", poses, rep["ate"], GATE_CAM_ATE_TRANS_RMSE_M,
                            GATE_CAM_ATE_ROT_RMSE_DEG)
    return rep


def phase_cli(cfg, out_dir: str, n_scans: int = N_SCANS, n_points: int | None = None) -> dict:
    """gcslam_tpu.eval.run on a JSON config holding `cfg`; must pass its audit."""
    from gcslam_tpu.eval import run as eval_run

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "config.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    t0 = time.perf_counter()
    metrics = eval_run.main(["--config", path, "--out", out_dir, "--scans", str(n_scans),
                             "--points", str(n_points or cfg.n_points_cap)])
    with open(os.path.join(out_dir, "audit.json")) as f:
        audit = json.load(f)
    rep = {"seconds": time.perf_counter() - t0,
           "ate_trans_m": metrics["ate"]["translation"]["rmse"],
           "audit_pass": bool(audit.get("all_pass", False)),
           "dashboard": metrics.get("dashboard", "written")}
    rep["failures"] = [] if rep["audit_pass"] else ["cli: artifact audit failed"]
    return rep


def phase_four(cfg, n_scans: int = FOUR_SCANS, n_devices: int = 4) -> dict:
    """Every mesh family over n_devices against one device, same process."""
    from gcslam_tpu.frontend.synthetic import SyntheticConfig, generate
    from gcslam_tpu.parallel import sweep

    run = generate(SyntheticConfig(n_scans=n_scans, n_points=cfg.n_points_cap))
    fams = sweep.replay_mesh_families(cfg, run.batches, n_devices, log=_say)
    fails = [f"{name}: non-finite" for name, r in fams.items() if not r["finite"]]
    fails += [f"{name}: max|dpose| {r['max_abs_dpose']:.3e} > {FOUR_TOL}"
              for name, r in fams.items() if r["max_abs_dpose"] > FOUR_TOL]
    return {"families": fams, "tolerance": FOUR_TOL, "failures": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precision", choices=("f32", "f64"), default="f32",
                    help="belief-algebra dtype (GCSLAM_BELIEF_DTYPE)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh families against one GPU")
    args = ap.parse_args(argv)
    # binds when gcslam_tpu is first imported
    os.environ["GCSLAM_BELIEF_DTYPE"] = {"f32": "float32", "f64": "float64"}[args.precision]

    try:
        import jax

        devices = jax.devices()
    except Exception as e:  # no usable backend at all
        print(f"chip_smoke: JAX found no device: {e}", file=sys.stderr)
        return 2
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's first device is {dev.platform!r} "
              f"({dev.device_kind}); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2
    try:
        import gcslam_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gcslam_tpu package is not importable here: {e}",
              file=sys.stderr)
        return 2
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.ops.sinkhorn_pallas import resolve_backend
    from gcslam_tpu.utils.cache import enable_compile_cache
    from gcslam_tpu.utils.xla import BELIEF_DTYPE

    cache_dir = enable_compile_cache()
    card = nvidia_smi()
    belief = jax.numpy.dtype(BELIEF_DTYPE).name
    _say(f"device: {dev.device_kind} x{len(devices)} | jax {jax.__version__} | "
         f"belief dtype {belief} | compile cache {cache_dir}")
    _say(f"nvidia-smi: {card}")
    cfg = PipelineConfig()
    cfg.validate()
    _say(f"sinkhorn backend: {resolve_backend(cfg.sinkhorn_backend, dev.platform, BELIEF_DTYPE)}")

    failures: list = []
    if args.four:
        rep = phase_four(cfg, n_devices=4)
        failures += rep["failures"]
        _say(f"four: tolerance {FOUR_TOL} on max|pose - single GPU| over {FOUR_SCANS} scans")
    else:
        pre = precompile(cfg, PipelineConfig(with_camera=True))
        _say(f"compile [{card}] (s, four programs at once): " + json.dumps(pre))
        rep = phase_kernel()
        for case, r in rep["cases"].items():
            _say(f"kernel {case}: max abs {r['max_abs']:.3e}, max rel {r['max_rel']:.3e} "
                 f"(tol atol {KERNEL_ATOL:g} + rtol {KERNEL_RTOL:g}) {'ok' if r['ok'] else 'FAIL'}")
        if not rep["ok"]:
            failures.append("kernel: Sinkhorn kernel disagrees with the XLA loop")

        phases = (("main", lambda: phase_main(cfg)),
                  ("camera", lambda: phase_camera(PipelineConfig(with_camera=True))),
                  ("cli", lambda: phase_cli(cfg, os.path.join("results", "chip_smoke_cli"))))
        for name, fn in phases:
            try:
                rep = fn()
            except Exception as e:  # a phase that raises fails the smoke
                failures.append(f"{name}: {type(e).__name__}: {e}")
                _say(f"{name}: FAILED with {type(e).__name__}: {e}")
                continue
            failures += rep.pop("failures")
            _say(f"{name} [{card}]: " + json.dumps(rep, default=float))

    if failures:
        for f in failures:
            print(f"chip_smoke FAIL: {f}", file=sys.stderr)
        return 1
    _say(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
