"""Constant-twist deskew into the scan-END body frame:
p_end = Exp(xi)^{-1} Exp(alpha * xi) ⊙ p per point.

Reference operators/deskew_constant_twist.py:32-117. alpha is the per-point
phase in the scan window (no hard clipping — soft time-membership weights
handle the boundary). The warp runs in POINT_DTYPE (f32): 8192 points of
small trig — elementwise work that XLA fuses into one kernel.

Frame convention (deviation, correctness): with X(alpha) = X_start Exp(alpha
xi), a point measured at phase alpha satisfies p_world = X(alpha) ⊙ p, so the
scan-END body coordinates are X(1)^{-1} X(alpha) ⊙ p. The rest of the
pipeline (prediction, map evidence, map insertion) linearizes at the scan-END
pose, so deskewing to any other frame leaves a one-scan-twist bias (~|v| dt,
|w| dt) in every map residual, which integrates into trajectory drift.
"""

from __future__ import annotations

from typing import Tuple

from gcslam_tpu.utils.xla import jnp, POINT_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.ops import se3
from gcslam_tpu.ops.certs import Cert, make_cert
from gcslam_tpu.ops.windows import smooth_window_weights


def deskew_constant_twist(
    points: jnp.ndarray,  # (N, 3)
    timestamps: jnp.ndarray,  # (N,)
    weights: jnp.ndarray,  # (N,)
    scan_start_time: jnp.ndarray,
    scan_end_time: jnp.ndarray,
    xi_body: jnp.ndarray,  # (6,) twist over the full scan interval
    ess_imu: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, Cert]:
    denom = jnp.maximum(scan_end_time - scan_start_time, 1e-12)
    alpha = ((timestamps - scan_start_time) / denom).astype(POINT_DTYPE)

    xi = xi_body.astype(POINT_DTYPE)
    # p_end = Exp(xi)^{-1} Exp(alpha xi) ⊙ p, batched over points.
    T_a = se3.se3_exp(alpha[:, None] * xi[None, :])  # (N, 6)
    R_a = se3.so3_exp(T_a[:, 3:6])  # (N, 3, 3)
    p_start = jnp.einsum("nij,nj->ni", R_a, points.astype(POINT_DTYPE)) + T_a[:, :3]
    T_1 = se3.se3_exp(xi)
    R_1 = se3.so3_exp(T_1[3:6])
    p0 = jnp.einsum("ji,nj->ni", R_1, p_start - T_1[None, :3])

    sigma = C.TIME_WARP_SIGMA_FRAC * denom
    w_time = smooth_window_weights(timestamps, scan_start_time, scan_end_time, sigma)
    weights_out = (weights * w_time).astype(POINT_DTYPE)

    retained = jnp.sum(weights_out) / (jnp.sum(weights) + C.EPS_MASS)
    cert = make_cert(exact=True, ess_total=ess_imu, support_frac=retained)
    return p0, weights_out, cert
