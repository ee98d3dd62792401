"""Pre-compile the flagship pipeline programs into the persistent XLA cache
(the cold-start story).

A first-boot process pays the full compile for each program it dispatches.
The persistent compilation cache (gcslam_tpu/utils/cache.py) already
amortizes repeats, but only for programs that
have been compiled ONCE with byte-identical (shapes, config) keys. This tool
is the deploy-time AOT step: it lowers+compiles every flagship program —
per-scan streaming step, whole-bag replay, chunked streaming, and optionally
the camera variant — against the production shapes, so the NEXT process
(bench, eval.run, a live robot boot) reaches its first pose in seconds.

Cache keys include array SHAPES: warm with the same --scans/--chunk you will
run with (bench.py uses 50/10; a live robot warms the step + chunk programs,
which are scan-count-independent).

Usage:
  python -m gcslam_tpu.tools.warm_cache [--scans 50] [--chunk 10]
         [--camera] [--cpu] [--config PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--scans", type=int, default=50,
                   help="replay program length to warm (bench.py: 50)")
    p.add_argument("--chunk", type=int, default=10,
                   help="chunk length for the chunked program (bench.py: 10)")
    p.add_argument("--camera", action="store_true",
                   help="also warm the with_camera variant")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--config", default=None, help="YAML/JSON PipelineConfig")
    p.add_argument("--json", default=None, metavar="PATH")
    args = p.parse_args(argv)

    # Production precision — must match what bench.py / eval.run will run
    # with, or the cache keys miss. Re-exec pattern (see eval/run.py): the
    # dtype froze when `python -m` imported the package.
    import sys as _sys

    if os.environ.get("GCSLAM_BELIEF_DTYPE", "float64") != "float32":
        env = dict(os.environ, GCSLAM_BELIEF_DTYPE="float32")
        os.execve(_sys.executable,
                  [_sys.executable, "-m", "gcslam_tpu.tools.warm_cache"]
                  + [a for a in (argv if argv is not None else _sys.argv[1:])],
                  env)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from gcslam_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()

    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig, config_from_file
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_step import init_state
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

    cfg = config_from_file(args.config) if args.config else PipelineConfig()
    cfg.validate()
    report = {"cache_dir": cache_dir, "device": jax.devices()[0].platform,
              "scans": args.scans, "chunk": args.chunk}

    run = generate(SyntheticConfig(n_scans=max(args.scans, args.chunk),
                                   n_points=cfg.n_points_cap,
                                   with_camera=args.camera))
    state0 = init_state(cfg)
    b0 = run.batches[0]

    def warm(name, build):
        t0 = time.time()
        build().compile()
        report[name + "_s"] = round(time.time() - t0, 1)
        print(f"warmed {name}: {report[name + '_s']}s", flush=True)

    # 1. per-scan streaming step (live mode first pose)
    warm("step", lambda: runner._step_jit.lower(state0, b0, cfg))

    # 2. whole-bag replay at --scans (bench headline program)
    stacked = stack_scan_batches(run.batches[: args.scans])
    warm("replay", lambda: jax.jit(
        lambda s, b: runner.run_scan(s, b, cfg)).lower(state0, stacked))

    # 3. chunked streaming program at --chunk (live-operation mode).
    #    _chunk_jit takes the whole (n_chunks, chunk, ...) window tensor.
    n_chunks = max(args.scans // args.chunk, 1)
    head = jax.tree_util.tree_map(
        lambda x: x[: n_chunks * args.chunk].reshape(
            (n_chunks, args.chunk) + x.shape[1:]),
        stacked,
    )
    import numpy as np

    warm("chunked", lambda: runner._chunk_jit.lower(
        state0, head, 0, jax.numpy.zeros(6), jax.numpy.eye(6),
        jax.numpy.asarray(0.0), cfg))
    del np

    # 4. camera variant
    if args.camera:
        import dataclasses

        cfg_cam = dataclasses.replace(cfg, with_camera=True)
        cfg_cam.validate()
        state_cam = init_state(cfg_cam)
        warm("camera_step", lambda: runner._step_jit.lower(
            state_cam, b0, cfg_cam))
        warm("camera_replay", lambda: jax.jit(
            lambda s, b: runner.run_scan(s, b, cfg_cam)).lower(state_cam, stacked))

    n_entries = len([f for f in os.listdir(cache_dir) if f.endswith("-cache")])
    report["cache_entries"] = n_entries
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
