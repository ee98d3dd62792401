"""Optimized-HLO census of the production scan step — the measurement side
of the op-count campaign.

The earlier finding was that per-scan latency is BREADTH (thousands of
instructions and ~1.8k small fusions in the replay while-body), not any hot
kernel. This tool compiles the jitted scan step (or whole-bag replay) at production
budgets, dumps the optimized HLO, and reports:

  - instruction counts by opcode (top-level, i.e. what the scheduler runs);
  - fusion count + the largest fusions by contained-instruction count;
  - copy count and total copied bytes (the carry/layout overhead);
  - scalar (rank-0) op count at top level — the cert-plumbing signature;
  - per-annotation attribution when op_name metadata survives.

Usage:
  python -m gcslam_tpu.tools.hlo_census [--cpu] [--replay] [--json PATH]
"""

from __future__ import annotations

import argparse
import collections
import json
import re


def _shape_bytes(shape: str) -> int:
    """Bytes of an HLO shape string like 'f32[128,2048,3,3]{...}'."""
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape)
    if not m:
        return 0
    dt, dims = m.groups()
    sizes = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
             "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
             "pred": 1}
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * sizes.get(dt, 4)


def census(hlo_text: str) -> dict:
    # Computations start at column 0 ("%name (args) -> type {" or
    # "ENTRY ..."); instructions are indented.
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        if line and line[0] not in " \t}" and line.rstrip().endswith("{"):
            tok = line.split()[1] if line.startswith("ENTRY") else line.split()[0]
            cur = tok.lstrip("%")
            comps[cur] = []
        elif cur is not None and line.strip() == "}":
            cur = None
        elif cur is not None and line.strip():
            comps[cur].append(line)

    # Opcode per instruction line: "  %name = shape opcode(...)"
    ins_re = re.compile(r"=\s*(\(?[a-z0-9]+\[[^ ]*|\(.*?\))\s+([a-z][a-z0-9\-]*)\(")

    def comp_stats(lines):
        ops = collections.Counter()
        copy_bytes = 0
        scalar_ops = 0
        for ln in lines:
            m = ins_re.search(ln)
            if not m:
                continue
            shape, opcode = m.groups()
            ops[opcode] += 1
            if opcode == "copy":
                copy_bytes += _shape_bytes(shape.lstrip("("))
            if re.match(r"[a-z0-9]+\[\]", shape) and opcode not in ("constant",):
                scalar_ops += 1
        return ops, copy_bytes, scalar_ops

    # The replay body: the body= computation of the while with the largest
    # body; fall back to the biggest computation.
    while_re = re.compile(r"while\(.*body=%?([\w\.\-]+)")
    bodies = []
    for lines in comps.values():
        for ln in lines:
            m = while_re.search(ln)
            if m and m.group(1) in comps:
                bodies.append(m.group(1))
    if bodies:
        body_name = max(bodies, key=lambda b: len(comps[b]))
    else:
        body_name = max(comps, key=lambda k: len(comps[k])) if comps else ""
    body_lines = comps.get(body_name, [])
    ops, copy_bytes, scalar_ops = comp_stats(body_lines)

    # fusion sizes: instructions inside each fused/called computation the
    # body references
    called = set()
    call_re = re.compile(r"(?:calls=|to_apply=|fusion.*calls=)%?([\w\.\-]+)")
    for ln in body_lines:
        for m in re.finditer(r"calls=%?([\w\.\-]+)", ln):
            called.add(m.group(1))
    fusion_sizes = sorted((len(comps[c]) for c in called if c in comps),
                          reverse=True)

    total_ops = sum(len(v) for v in comps.values())
    return {
        "computations": len(comps),
        "total_instructions": total_ops,
        "body": body_name,
        "body_instructions": len(body_lines),
        "body_opcodes_top20": dict(ops.most_common(20)),
        "body_fusions": ops.get("fusion", 0),
        "body_copies": ops.get("copy", 0),
        "body_copy_bytes": copy_bytes,
        "body_scalar_ops": scalar_ops,
        "body_called_computations": len(called),
        "fusion_sizes_top10": fusion_sizes[:10],
        "fusion_size_median": (fusion_sizes[len(fusion_sizes) // 2]
                               if fusion_sizes else 0),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="census the whole-bag replay program (lax.scan)")
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--dump", default=None, help="also write the HLO text here")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="PipelineConfig overrides (JSON values), e.g. "
                         "--set with_map=false")
    args = ap.parse_args()

    import os
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from gcslam_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()

    import gcslam_tpu  # noqa: F401
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.scan_step import init_state, scan_step
    from gcslam_tpu.models.scan_io import stack_scan_batches
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = json.loads(v)
    cfg = PipelineConfig(**overrides)
    cfg.validate()
    n_pts = args.points or cfg.n_points_cap
    run = generate(SyntheticConfig(n_scans=args.scans, n_points=n_pts))
    state0 = init_state(cfg)
    if args.replay:
        stacked = stack_scan_batches(run.batches)
        fn = jax.jit(lambda s, b: runner.run_scan(s, b, cfg))
        lowered = fn.lower(state0, stacked)
    else:
        fn = jax.jit(lambda s, b: scan_step(s, b, cfg))
        lowered = fn.lower(state0, run.batches[0])
    compiled = lowered.compile()
    txt = compiled.as_text()
    rep = census(txt)
    rep["backend"] = jax.devices()[0].platform
    rep["program"] = "replay" if args.replay else "step"
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(txt)
        rep["hlo_path"] = args.dump
    out = json.dumps(rep, indent=1)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
