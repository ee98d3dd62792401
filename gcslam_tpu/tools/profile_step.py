"""Compile/cost/timing forensics for the jitted scan step — the per-stage
profiling analog of the reference's runtime counters + timing dashboards
(common/runtime_counters.py, tools/slam_dashboard.py timing panels), rebuilt
for the one-program design where "stages" are fused into a single XLA
executable:

  - XLA cost analysis: FLOPs, bytes accessed, peak memory of the compiled
    step (the whole-pipeline arithmetic/memory budget);
  - HLO op histogram: which op families dominate the optimized module
    (fusions, scatters, while loops, convolutions...);
  - wall timings: trace+lower / compile / steady-state per-scan latency
    (StepTimer percentiles over --steps scans);
  - optional xprof trace (--trace DIR) for tensorboard/xprof deep dives.

Usage:
  python -m gcslam_tpu.tools.profile_step [--cpu] [--steps 20] [--small]
         [--points 8192] [--trace /tmp/xprof]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--small", action="store_true", help="small map budgets")
    p.add_argument("--no-map", action="store_true")
    p.add_argument("--trace", default=None, metavar="DIR", help="write an xprof trace")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models.scan_step import init_state, scan_step
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.utils.profiling import StepTimer, trace

    kw = dict(with_map=not args.no_map)
    if args.small and not args.no_map:
        kw.update(atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128,
                  surfel_voxel_size_m=0.5)
    cfg = PipelineConfig(**kw)
    run = generate(SyntheticConfig(n_scans=args.steps + 1, n_points=args.points))
    state = init_state(cfg)

    fn = jax.jit(lambda s, b: scan_step(s, b, cfg))
    t0 = time.time()
    lowered = fn.lower(state, run.batches[0])
    t_lower = time.time() - t0
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0

    # XLA cost analysis (whole-program arithmetic/memory budget)
    cost = {}
    try:
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        for k in ("flops", "bytes accessed", "optimal_seconds"):
            if k in ca:
                cost[k.replace(" ", "_")] = float(ca[k])
    except Exception as e:  # backend-dependent
        cost["error"] = str(e)
    mem = {}
    try:
        m = compiled.memory_analysis()
        for k in ("temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "generated_code_size_in_bytes"):
            v = getattr(m, k, None)
            if v is not None:
                mem[k] = int(v)
    except Exception:
        pass

    # HLO op histogram of the OPTIMIZED module
    hist: collections.Counter = collections.Counter()
    try:
        txt = compiled.as_text()
        for m_ in re.finditer(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*[\w\[\]{},\s]*?(\w+)\(", txt, re.M):
            hist[m_.group(1)] += 1
    except Exception:
        pass

    # steady-state timing
    timer = StepTimer()
    out = None
    state_r = state
    state_r, out = fn(state_r, run.batches[0])
    jax.block_until_ready(out.pose)  # warm
    ctx = trace(args.trace) if args.trace else None
    if ctx:
        ctx.__enter__()
    for b in run.batches[1 : args.steps + 1]:
        with timer.measure(out_ref=None):
            state_r, out = fn(state_r, b)
            jax.block_until_ready(out.pose)
    if ctx:
        ctx.__exit__(None, None, None)

    report = {
        "device": jax.devices()[0].platform,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "timing": timer.summary(),
        "cost_analysis": cost,
        "memory_analysis": mem,
        "hlo_top_ops": dict(hist.most_common(15)),
        "finite": bool(np.all(np.isfinite(np.asarray(out.pose)))),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
