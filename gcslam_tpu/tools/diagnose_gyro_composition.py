"""Gyro-evidence composition-side diagnostic: does the evidence push the
state in the SAME direction as the measured rotation increment?

The reference's tools/diagnose_gyro_composition.py:1-182 probes the classic
left/right composition mismatch (R @ exp(delta) vs exp(delta) @ R, or a
flipped residual sign): feed a known gyro delta into the gyro rotation
evidence and check that the zero-prior posterior increment
L_rot^{-1} h_rot has the same sign as the delta. We probe at identity AND
at non-trivial start rotations — the mismatch only shows away from
identity, where the two composition sides genuinely differ.

Also probes the odometry relative-pose factor the same way (our extension:
the same class of bug bites any relative factor).

Usage:
  python -m gcslam_tpu.tools.diagnose_gyro_composition [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _probe_gyro(rotvec_start, delta_rotvec, dt_int=0.1):
    import gcslam_tpu  # noqa: F401  (x64 before array creation)
    from gcslam_tpu import constants as C
    from gcslam_tpu.ops import se3
    from gcslam_tpu.ops.evidence_imu import imu_gyro_rotation_evidence
    from gcslam_tpu.utils.xla import jnp

    rotvec_start = jnp.asarray(rotvec_start, dtype=float)
    delta = jnp.asarray(delta_rotvec, dtype=float)
    # prediction did not move: end_pred = start, so the whole delta is the
    # residual the evidence must reproduce
    L, h, r_rot, cert = imu_gyro_rotation_evidence(
        rotvec_start_WB=rotvec_start,
        rotvec_end_pred_WB=rotvec_start,
        delta_rotvec_meas=delta,
        Sigma_g=1e-3 * jnp.eye(3),
        dt_int=jnp.asarray(dt_int),
    )
    L_rot = np.asarray(L[C.IDX_ROT, C.IDX_ROT], dtype=float)
    h_rot = np.asarray(h[C.IDX_ROT], dtype=float)
    post = np.linalg.solve(L_rot + 1e-12 * np.eye(3), h_rot)

    # ground truth: the increment that takes R_pred to R_start@exp(delta),
    # expressed in the prediction's tangent (right perturbation)
    R_start = np.asarray(se3.so3_exp(rotvec_start), dtype=float)
    R_end = np.asarray(se3.so3_exp(rotvec_start), dtype=float) @ np.asarray(
        se3.so3_exp(delta), dtype=float)
    expected = np.asarray(
        se3.so3_log(jnp.asarray(R_start.T @ R_end)), dtype=float)
    same_sign = bool(np.dot(post, expected) > 0)
    return {
        "rotvec_start_deg": [round(float(np.degrees(v)), 2) for v in np.asarray(rotvec_start)],
        "delta_deg": [round(float(np.degrees(v)), 2) for v in np.asarray(delta)],
        "posterior_increment_deg": [round(float(np.degrees(v)), 3) for v in post],
        "expected_increment_deg": [round(float(np.degrees(v)), 3) for v in expected],
        "residual_matches_delta": bool(np.linalg.norm(np.asarray(r_rot) - expected) < 1e-6),
        "same_direction": same_sign,
        "increment_error_deg": round(float(np.degrees(np.linalg.norm(post - expected))), 4),
    }


def _probe_odom_relative():
    """Same test on the relative odometry factor: previous pose known, odom
    says 'moved +x and +10 deg yaw' — does the factor pull the current pose
    there?"""
    import gcslam_tpu  # noqa: F401
    from gcslam_tpu import constants as C
    from gcslam_tpu.ops import se3
    from gcslam_tpu.ops.evidence_odom import odom_quadratic_evidence
    from gcslam_tpu.utils.xla import jnp

    prev = jnp.asarray([1.0, 2.0, 0.0, 0.0, 0.0, np.deg2rad(30.0)])
    delta = jnp.asarray([0.5, 0.0, 0.0, 0.0, 0.0, np.deg2rad(10.0)])
    target = se3.se3_compose(prev, se3.se3_exp(delta))
    # predicted current pose = previous (no motion applied): full pull = delta
    pred = prev
    L, h, cert = odom_quadratic_evidence(
        pose_pred=pred,
        odom_pose=target,
        odom_cov=1e-4 * jnp.eye(6),
    )
    Lp = np.asarray(L[C.IDX_POSE, C.IDX_POSE], dtype=float)
    hp = np.asarray(h[C.IDX_POSE], dtype=float)
    post = np.linalg.solve(Lp + 1e-9 * np.eye(6), hp)
    expected = np.asarray(
        se3.se3_log(se3.se3_relative(target, pred)), dtype=float)
    return {
        "posterior_increment": [round(float(v), 4) for v in post],
        "expected_increment": [round(float(v), 4) for v in expected],
        "same_direction": bool(np.dot(post, expected) > 0),
        "increment_error": round(float(np.linalg.norm(post - expected)), 5),
    }


def diagnose_gyro_composition() -> dict:
    probes = [
        _probe_gyro([0.0, 0.0, 0.0], [0.0, 0.0, np.deg2rad(10)]),
        _probe_gyro([0.0, 0.0, np.deg2rad(90)], [0.0, 0.0, np.deg2rad(10)]),
        _probe_gyro([np.deg2rad(20), 0.0, np.deg2rad(45)],
                    [np.deg2rad(-5), np.deg2rad(3), np.deg2rad(10)]),
    ]
    ok = all(p["same_direction"] and p["increment_error_deg"] < 0.5
             for p in probes)
    try:
        odom = _probe_odom_relative()
        odom_ok = odom["same_direction"] and odom["increment_error"] < 1e-2
    except Exception as e:  # signature drift must not kill the gyro verdict
        odom, odom_ok = {"error": str(e)[:200]}, None
    return {
        "gyro_probes": probes,
        "odom_relative_probe": odom,
        "verdict": ("OK" if ok and odom_ok is not False
                    else "COMPOSITION_MISMATCH"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")  # tiny probe; never pay device dispatch
    info = diagnose_gyro_composition()
    if args.json:
        print(json.dumps(info, indent=2))
    else:
        for i, pr in enumerate(info["gyro_probes"]):
            print(f"gyro probe {i}: start={pr['rotvec_start_deg']} deg  "
                  f"delta={pr['delta_deg']} deg")
            print(f"  posterior increment {pr['posterior_increment_deg']} deg  "
                  f"(expected {pr['expected_increment_deg']}; "
                  f"err {pr['increment_error_deg']} deg)  "
                  f"{'ok' if pr['same_direction'] else 'OPPOSITE DIRECTION'}")
        od = info["odom_relative_probe"]
        if "error" not in od:
            print(f"odom relative probe: err {od['increment_error']}  "
                  f"{'ok' if od['same_direction'] else 'OPPOSITE DIRECTION'}")
        print(f"verdict: {info['verdict']}")
    return 0 if info["verdict"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
