"""The Sinkhorn kernel against the XLA loop on the GPU, in one process.

  python -m gcslam_tpu.tools.sinkhorn_ab [--scans 50] [--rounds 2] [--json PATH]

1. Solver alone: device time per call of ops/sinkhorn_pallas.py's kernel and
   of association._sinkhorn_unbalanced at N=1024 and N=1536 (K=8, 50
   iterations), single and under the K_HYP=4 vmap. Each figure is one jitted
   program that chains --reps calls (a data dependency between them), so
   per-call dispatch is not in it.
2. End to end: the production replay (runner.run_scan over --scans scans at
   PipelineConfig() budgets, f32 belief) compiled with sinkhorn_backend="xla"
   and with "pallas", timed in turns (xla, pallas, pallas, xla) x --rounds.
   Every timed replay ends in block_until_ready; one more replay per backend
   ends in a host read of the poses instead, which cannot finish before the
   device does, as a check on the first.

Needs a GPU; prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _solver_ms(fn, C, reps: int) -> float:
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(C):
        def body(c, _):
            pi = fn(c)
            return c + 0.0 * jnp.sum(pi), None

        return jax.lax.scan(body, C, None, length=reps)[0]

    jax.block_until_ready(chained(C))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(chained(C))
    return (time.perf_counter() - t0) / reps * 1e3


def solver_times(reps: int) -> dict:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gcslam_tpu.ops.association import _sinkhorn_unbalanced
    from gcslam_tpu.ops.sinkhorn_pallas import sinkhorn_unbalanced_pallas

    out = {}
    rng = np.random.default_rng(0)
    for n in (1024, 1536):
        C = jnp.asarray(rng.uniform(0, 5, (4, n, 8)).astype(np.float32))
        a = jnp.full((n,), 1.0 / n, jnp.float32)
        b = jnp.full((8,), 1.0 / 8, jnp.float32)
        solvers = {
            "xla": lambda c: _sinkhorn_unbalanced(c, a, b, 0.05, 1.0, 1.0, 50),
            "pallas": lambda c: sinkhorn_unbalanced_pallas(c, a, b, 0.05, 1.0, 1.0, 50),
        }
        for name, f in solvers.items():
            out[f"N={n} {name} ms"] = _solver_ms(f, C[0], reps)
            out[f"N={n} vmap4 {name} ms"] = _solver_ms(jax.vmap(f), C, reps)
    return out


def replay_ab(n_scans: int, rounds: int) -> dict:
    import numpy as np
    import jax
    from gcslam_tpu.frontend.synthetic import SyntheticConfig, generate
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.models.scan_step import init_state

    cfgs = {b: PipelineConfig(sinkhorn_backend=b) for b in ("xla", "pallas")}
    run = generate(SyntheticConfig(n_scans=n_scans, n_points=cfgs["xla"].n_points_cap))
    batches = jax.device_put(stack_scan_batches(run.batches))
    rep = {"compile_s": {}, "ms_per_scan": {b: [] for b in cfgs},
           "host_read_ms_per_scan": {}}
    poses = {}
    for b, cfg in cfgs.items():
        t0 = time.perf_counter()
        _, out = runner.run_scan(init_state(cfg), batches, cfg)
        poses[b] = np.asarray(out.pose)
        rep["compile_s"][b] = time.perf_counter() - t0
    for _ in range(rounds):
        for b in ("xla", "pallas", "pallas", "xla"):
            cfg = cfgs[b]
            s0 = init_state(cfg)
            jax.block_until_ready(s0)
            t0 = time.perf_counter()
            _, out = runner.run_scan(s0, batches, cfg)
            jax.block_until_ready(out.pose)
            rep["ms_per_scan"][b].append((time.perf_counter() - t0) / n_scans * 1e3)
    for b, cfg in cfgs.items():
        s0 = init_state(cfg)
        jax.block_until_ready(s0)
        t0 = time.perf_counter()
        _, out = runner.run_scan(s0, batches, cfg)
        np.asarray(out.pose)
        rep["host_read_ms_per_scan"][b] = (time.perf_counter() - t0) / n_scans * 1e3
    rep["median_ms_per_scan"] = {b: float(np.median(v)) for b, v in rep["ms_per_scan"].items()}
    rep["max_abs_dpose_pallas_vs_xla"] = float(np.abs(poses["pallas"] - poses["xla"]).max())
    return rep


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=int, default=50)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    # the kernel path is the f32 one; the dtype binds at package import
    if os.environ.get("GCSLAM_BELIEF_DTYPE") != "float32":
        os.execve(sys.executable,
                  [sys.executable, "-m", "gcslam_tpu.tools.sinkhorn_ab"]
                  + (argv if argv is not None else sys.argv[1:]),
                  dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"sinkhorn_ab: needs a GPU, found {dev.platform!r}")
    from gcslam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    out["solver"] = solver_times(args.reps)
    print("solver", json.dumps(out["solver"]), flush=True)
    out["replay"] = replay_ab(args.scans, args.rounds)
    print(json.dumps(out), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
