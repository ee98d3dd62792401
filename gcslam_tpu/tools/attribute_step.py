"""Per-stage cost/latency attribution of the jitted scan step by config
deltas — the honest-timing complement to tools/profile_step (which profiles
ONE program): compile the step under a family of config variants that each
disable or shrink one stage, measure steady-state latency (each timed
region ends in block_until_ready) + XLA cost analysis, and report the deltas
against the base.

Every variant (the base too) runs in its own child process, one at a time;
the parent never imports JAX, so exactly one process holds the device.

In the one-program design there are no per-stage timers to read (everything
is fused into one XLA executable; host-side stage timing would require
breaking the program apart and paying dispatch per stage) — config-delta
attribution measures what each stage actually costs IN CONTEXT, including
whatever fusion XLA does across stage boundaries.

Variants (each independently toggles one knob off the production base):
  no_map        with_map=False          -> whole map branch + map update
  gn_1round     map_icp_iters=1         -> per-GN-round association/evidence
  full_pool     k_shortlist=0           -> shortlist vs full-pool cost tile
  no_merge      k_merge_pairs_tile=0    -> merge-reduce
  view_256      m_tile_view=256         -> view-size-proportional work
  tiles_32      atlas_max_tiles=32      -> atlas-size-proportional work

Usage:
  python -m gcslam_tpu.tools.attribute_step [--cpu] [--steps 10]
         [--points 8192] [--variants no_map,gn_1round,...] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import time

VARIANTS = {
    "no_map": {"with_map": False},
    "gn_1round": {"map_icp_iters": 1},
    "full_pool": {"k_shortlist": 0},
    "no_merge": {"k_merge_pairs_tile": 0},
    "view_256": {"m_tile_view": 256},
    "tiles_32": {"atlas_max_tiles": 32},
    # compile-time-budget variants: production fail-fast pins config budgets
    # to the compiled constants, so these rebuild the constants through the
    # sanctioned GCSLAM_* environment overrides in their child process.
    "sinkhorn_10": {"_env": {"GCSLAM_K_SINKHORN": "10"}},
    "sinkhorn_20": {"_env": {"GCSLAM_K_SINKHORN": "20"}},
    "hyp_1": {"_env": {"GCSLAM_K_HYP": "1"}},
    "hyp_2": {"_env": {"GCSLAM_K_HYP": "2"}},
    "surfel_512": {"n_surfel": 512},
    "m_tile_1024": {"m_tile": 1024},
    "shortlist_16": {"k_shortlist": 16},
    "no_share": {"map_share_extraction": False, "map_gn_shared": False},
    "per_hyp_gn": {"map_gn_shared": False},
    "camera_on": {"with_camera": True},
    "insert_1": {"k_insert_tile": 1},
    "view_512": {"m_tile_view": 512},
    "gn_3rounds": {"map_icp_iters": 3},
}


def measure_replay(cfg, stacked, n_scans: int) -> dict:
    """Variant latency on the REPLAY program (lax.scan over the bag) — the
    same program bench.py's headline measures. Per-step attribution
    (measure) includes per-dispatch host overhead; the replay deltas are
    the ones that move the headline number."""
    import jax
    from gcslam_tpu.models.scan_step import init_state
    from gcslam_tpu.models import runner

    state0 = init_state(cfg)
    fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg))
    rep = {}
    t0 = time.time()
    jax.block_until_ready(fn(state0, stacked))
    rep["compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    jax.block_until_ready(fn(state0, stacked))
    rep["ms_per_scan"] = round((time.time() - t0) / n_scans * 1000.0, 3)
    return rep


def measure(cfg, batches, steps: int) -> dict:
    import jax
    from gcslam_tpu.models.scan_step import init_state, scan_step

    state = init_state(cfg)
    fn = jax.jit(lambda s, b: scan_step(s, b, cfg))
    t0 = time.time()
    compiled = fn.lower(state, batches[0]).compile()
    t_compile = time.time() - t0

    rep = {"compile_s": round(t_compile, 1)}
    try:
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        rep["gflops"] = round(float(ca.get("flops", 0.0)) / 1e9, 3)
        rep["gbytes"] = round(
            float(ca.get("bytes accessed", ca.get("bytes_accessed", 0.0))) / 1e9, 4
        )
    except Exception:
        pass

    # Steady state: warm-up, then `steps` timed executions (state threads
    # through so the map grows realistically), each ending in
    # block_until_ready.
    state, out = fn(state, batches[0])
    jax.block_until_ready(out)
    times = []
    for i in range(steps):
        b = batches[1 + (i % (len(batches) - 1))]
        t0 = time.time()
        state, out = fn(state, b)
        jax.block_until_ready(out)
        times.append(time.time() - t0)
    times.sort()
    n = len(times)
    rep["ms_p50"] = round(times[n // 2] * 1e3, 3)
    rep["ms_mean"] = round(sum(times) / n * 1e3, 3)
    return rep


def run_child(name: str, args) -> dict:
    """Measure ONE variant ("base" or a VARIANTS key) in this process."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.utils.cache import enable_compile_cache

    # re-runs of the sweep skip recompiles of unchanged variants
    enable_compile_cache()
    base_kw = {}
    if args.small:
        base_kw = dict(atlas_max_tiles=16, m_tile=256, m_tile_view=128,
                       n_surfel=256, surfel_voxel_size_m=0.4)
    cfg = PipelineConfig(**base_kw)
    over = {k: v for k, v in VARIANTS.get(name, {}).items() if k != "_env"}
    cfg = dataclasses.replace(cfg, **over)
    cfg.validate()
    n_scans = args.replay if args.replay else max(args.steps + 1, 4)
    run = generate(SyntheticConfig(n_scans=n_scans,
                                   n_points=min(args.points, cfg.n_points_cap)))
    if args.replay:
        from gcslam_tpu.models.scan_io import stack_scan_batches

        rep = measure_replay(cfg, stack_scan_batches(run.batches), n_scans)
    else:
        rep = measure(cfg, run.batches, args.steps)
    from gcslam_tpu.utils import xla as _xla

    dev = jax.devices()[0]
    rep["device"] = {"platform": dev.platform, "kind": dev.device_kind}
    rep["belief_dtype"] = str(_xla.BELIEF_DTYPE.__name__)
    rep["budgets"] = {"atlas": f"{cfg.atlas_max_tiles}x{cfg.m_tile}",
                      "view": cfg.m_tile_view, "k_shortlist": cfg.k_shortlist,
                      "gn_rounds": cfg.map_icp_iters}
    return rep


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--small", action="store_true", help="small map budgets (test mode)")
    p.add_argument("--replay", type=int, default=0, metavar="N",
                   help="measure the N-scan replay program (run_scan) per "
                        "variant instead of per-step dispatch")
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma list from: " + ",".join(VARIANTS))
    p.add_argument("--json", default=None, metavar="PATH")
    p.add_argument("--precision", default="f32", choices=["f32", "f64"],
                   help="belief-algebra dtype for the sweep. Default f32 — "
                        "the production precision (same as bench.py)")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.child is not None:
        print("CHILD_JSON " + json.dumps(run_child(args.child, args)), flush=True)
        return {}

    import os
    import subprocess
    import sys

    # The dtype binds when gcslam_tpu is first imported, so it reaches each
    # child through its environment.
    dtype = "float32" if args.precision == "f32" else "float64"
    common = ["--points", str(args.points), "--steps", str(args.steps)]
    if args.replay:
        common += ["--replay", str(args.replay)]
    if args.cpu:
        common += ["--cpu"]
    if args.small:
        common += ["--small"]

    def child(name: str) -> dict:
        env = dict(os.environ, GCSLAM_BELIEF_DTYPE=dtype,
                   **VARIANTS.get(name, {}).get("_env", {}))
        r = subprocess.run(
            [sys.executable, "-m", "gcslam_tpu.tools.attribute_step",
             "--child", name] + common, env=env, capture_output=True, text=True)
        for line in r.stdout.splitlines():
            if line.startswith("CHILD_JSON "):
                return json.loads(line[len("CHILD_JSON "):])
        return {"error": (r.stderr or r.stdout)[-300:]}

    out = {"replay": args.replay, "belief_dtype": dtype}
    out["base"] = child("base")
    print("base", json.dumps(out["base"]), flush=True)
    key = "ms_per_scan" if args.replay else "ms_p50"
    for name in [v for v in args.variants.split(",") if v]:
        if args.small and name in ("view_256", "tiles_32"):
            continue  # small mode: variant not meaningful
        out[name] = child(name)
        if key in out[name] and key in out["base"]:
            out[name]["delta_ms"] = round(out["base"][key] - out[name][key], 3)
        print(name, json.dumps(out[name]), flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
