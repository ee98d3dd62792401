"""GATED canonical-path rehearsal + frontend-stage attribution.

The reference's single test path is the gated bag replay
(tools/run_and_evaluate_gc.sh:333-645, gate note :635-640). No real bag
ships in this environment, so the stand-in is the real-schema synthesized
Kimera bag (frontend/bag_synth.py): VLP-16 CDR scans, 200 Hz IMU, odometry,
JPEG+depth camera frames, per-topic inverse-skewed clocks. This tool:

  1. synthesizes the bag (once, cached by content args);
  2. runs the FULL production frontend+pipeline on it (`eval.run --bag`)
     and GATES the resulting ATE — rc != 0 on failure;
  3. attributes the bag-vs-control accuracy delta by toggling one frontend
     stage at a time: direct-ScanBatch control, camera off, raw (k=1)
     anchor, time-alignment profile off, pure-Python decode.

Usage:
  python -m gcslam_tpu.tools.rehearse [--quick] [--json results/rehearsal.json]
         [--variants full,control,...] [--out-base results/rehearsal]

Gate (production thresholds, committed):
  ATE trans RMSE <= 0.38 m  (reference parity bar, CHANGELOG.md:333)
  ATE rot RMSE   <= 4.0 deg (2x headroom over the measured post-camera-fix
                             rehearsal result; reference parity is 0.65)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GATE_TRANS_M = 0.38
GATE_ROT_DEG = 4.0

BAG = "results/kimera_synth.db3"
GT = "results/kimera_synth_gt.tum"
CONFIG = "configs/gc_kimera.yaml"

VARIANTS = {
    # name -> (uses_bag, extra eval.run args)
    "full": (True, []),
    "control": (False, ["--scans", "160", "--trajectory", "circuit",
                        "--odom-model", "integrated", "--drift", "0.02",
                        "--camera", "--loop"]),
    "no_camera": (True, ["--no-camera"]),
    "anchor_raw": (True, ["--frontend-set", "anchor_smoothing_k=1"]),
    "no_align": (True, ["--frontend-set", "alignment=none"]),
    "python_decode": (True, []),  # GCSLAM_NO_NATIVE=1
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/rehearsal.json")
    ap.add_argument("--out-base", default="results/rehearsal")
    ap.add_argument("--variants", default="full,control,no_camera,anchor_raw,"
                                          "no_align,python_decode")
    ap.add_argument("--scans", type=int, default=160)
    ap.add_argument("--quick", action="store_true",
                    help="gate-only: run just the 'full' variant")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.chdir(repo)

    if not os.path.exists(BAG):
        print(f"[rehearse] synthesizing {BAG} ...", flush=True)
        os.makedirs(os.path.dirname(BAG), exist_ok=True)
        subprocess.run(
            [sys.executable, "-m", "gcslam_tpu.tools.make_synth_bag",
             "--out", BAG, "--gt", GT, "--config", CONFIG,
             "--scans", str(args.scans), "--trajectory", "circuit",
             "--odom-model", "integrated"],
            check=True)

    names = ["full"] if args.quick else args.variants.split(",")
    rows = {}
    for name in names:
        uses_bag, extra = VARIANTS[name]
        out_dir = f"{args.out_base}_{name}"
        cmd = [sys.executable, "-m", "gcslam_tpu.eval.run",
               "--out", out_dir, "--chunk", "10"]
        if uses_bag:
            cmd += ["--bag", BAG, "--config", CONFIG, "--gt", GT, "--loop"]
        cmd += extra
        if args.cpu:
            cmd += ["--cpu"]
        env = dict(os.environ)
        if name == "python_decode":
            env["GCSLAM_NO_NATIVE"] = "1"
        print(f"[rehearse] {name}: {' '.join(cmd)}", flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, env=env)
        if r.returncode != 0:
            rows[name] = {"error": f"eval.run rc={r.returncode}"}
            continue
        with open(os.path.join(out_dir, "metrics.json")) as f:
            m = json.load(f)
        rows[name] = {
            "ate_trans_rmse_m": round(m["ate"]["translation"]["rmse"], 4),
            "ate_rot_rmse_deg": round(m["ate"]["rotation_deg"]["rmse"], 3),
            "rpe1m_trans_rmse_m": round(
                m["rpe"]["1m"]["translation"]["rmse"], 4)
            if m["rpe"]["1m"]["translation"] else None,
            "wall_s": round(time.time() - t0, 1),
        }
        # audit must pass on the full variant
        audit_path = os.path.join(out_dir, "audit.json")
        if os.path.exists(audit_path):
            with open(audit_path) as f:
                audit = json.load(f)
            rows[name]["audit_all_pass"] = all(
                v.get("pass", False) for v in audit.values()
                if isinstance(v, dict))

    full = rows.get("full", {})
    failures = []
    if "error" in full:
        failures.append(full["error"])
    else:
        if full.get("ate_trans_rmse_m", 1e9) > GATE_TRANS_M:
            failures.append(
                f"trans {full['ate_trans_rmse_m']} > {GATE_TRANS_M}")
        if full.get("ate_rot_rmse_deg", 1e9) > GATE_ROT_DEG:
            failures.append(f"rot {full['ate_rot_rmse_deg']} > {GATE_ROT_DEG}")
        if full.get("audit_all_pass") is False:
            failures.append("audit failed")

    report = {
        "gate": "PASS" if not failures else "FAIL: " + "; ".join(failures),
        "gate_thresholds": {"ate_trans_rmse_m": GATE_TRANS_M,
                            "ate_rot_rmse_deg": GATE_ROT_DEG},
        "variants": rows,
        "bag": BAG,
        "scans": args.scans,
    }
    out = json.dumps(report, indent=1)
    print(out)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        f.write(out + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
