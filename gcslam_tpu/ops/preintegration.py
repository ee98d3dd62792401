"""IMU preintegration — parallel (log-depth) associative-scan formulation.

Semantics match the reference's sequential 512-step lax.scan
(fl_slam_poc/backend/operators/imu_preintegration.py:47-150) exactly:

    dt_eff_k = w_k (t_{k+1} - t_k)            (continuous soft membership)
    R_{k+1}  = R_k Exp((gyro_k - bg) dt_eff_k),  R_0 = R_start
    a_w_k    = R_k (accel_k - ba) + g
    v_{k+1}  = v_k + a_w_k dt_eff_k
    p_{k+1}  = p_k + v_k dt_eff_k + 1/2 a_w_k dt_eff_k^2

Array-program redesign: the only sequential dependency is the cumulative
rotation product, which is ASSOCIATIVE — so we compute the exclusive
cumulative product of the per-sample delta rotations with
`jax.lax.associative_scan` (depth log2(M) instead of M sequential steps;
the reference itself flags the 512-step sequential scan as a bottleneck,
docs/PIPELINE_DESIGN_GAPS.md:196-212). Velocity/position then reduce to
(exclusive) cumulative sums — embarrassingly parallel.

All outputs are expressed in the START BODY frame for frame-consistent
SE(3), matching imu_preintegration.py:123-143.
"""

from __future__ import annotations

from typing import NamedTuple

from gcslam_tpu.utils.xla import jax, jnp
from gcslam_tpu.ops import se3


class PreintResult(NamedTuple):
    delta_pose: jnp.ndarray  # (6,) [p_body, rotvec_delta] start-body-frame
    delta_R: jnp.ndarray  # (3, 3) R_start^T R_end
    delta_p: jnp.ndarray  # (3,) start-body-frame position change
    delta_v: jnp.ndarray  # (3,) start-body-frame velocity change
    ess: jnp.ndarray  # sum of weights
    a_body_mean: jnp.ndarray  # (3,) dt_eff-weighted mean debiased body accel
    a_world_nog_mean: jnp.ndarray  # (3,) rotated accel mean (no gravity)
    a_world_mean: jnp.ndarray  # (3,) rotated accel + gravity mean
    dt_eff_sum: jnp.ndarray  # sum of effective dts


def preintegrate(
    imu_stamps: jnp.ndarray,  # (M,) zero-padded
    imu_gyro: jnp.ndarray,  # (M, 3) rad/s
    imu_accel: jnp.ndarray,  # (M, 3) m/s^2
    weights: jnp.ndarray,  # (M,) continuous membership
    rotvec_start_WB: jnp.ndarray,  # (3,)
    gyro_bias: jnp.ndarray,  # (3,)
    accel_bias: jnp.ndarray,  # (3,)
    gravity_W: jnp.ndarray,  # (3,)
    target_dt: jnp.ndarray = None,  # () total integration time to normalize to
) -> PreintResult:
    dtype = imu_gyro.dtype
    stamps = imu_stamps
    # dt_k = t_{k+1} - t_k, last forced to 0, clipped >= 0 (padding-safe).
    # Stamps are TIME_DTYPE (f64 absolute); the DIFFERENCES are small and
    # cast to the compute dtype here so f32-belief mode stays f32 downstream.
    dt = jnp.concatenate(
        [(stamps[1:] - stamps[:-1]).astype(dtype), jnp.zeros((1,), dtype=dtype)]
    )
    dt = jnp.maximum(dt, 0.0)
    dt_eff = weights.astype(dtype) * dt  # (M,)
    if target_dt is not None:
        # Soft-window time normalization: the membership weights taper at the
        # window edges and the last sample's forward-diff interval is zero,
        # so sum(w * dt) systematically under-covers the window by ~2 sigma_warp
        # + one sample period. Left uncorrected, every preintegrated increment
        # (rotation AND velocity) is scaled by that deficit (~0.85 at 100 Hz /
        # 10 ms sigma), which integrates into proportional trajectory error
        # (est_yaw = 0.85 * gt_yaw). Renormalize total effective time to the
        # known coverage; relative soft weighting is preserved. The clip keeps
        # dropout windows (true coverage < target) from fabricating motion.
        scale = target_dt.astype(dtype) / jnp.maximum(jnp.sum(dt_eff), 1e-9)
        dt_eff = dt_eff * jnp.clip(scale, 0.0, 1.5)

    omega = (imu_gyro - gyro_bias[None, :]) * dt_eff[:, None]  # (M, 3)
    dR = se3.so3_exp(omega)  # (M, 3, 3)

    # Inclusive cumulative product P_k = dR_0 @ ... @ dR_k (log-depth).
    P = jax.lax.associative_scan(jnp.matmul, dR)
    # Exclusive product C_k = P_{k-1}, C_0 = I: the body->start rotation at
    # the time accel sample k is applied (carry value BEFORE the update).
    eye = jnp.eye(3, dtype=dtype)[None]
    C = jnp.concatenate([eye, P[:-1]], axis=0)  # (M, 3, 3)

    R_start = se3.so3_exp(rotvec_start_WB.astype(dtype))
    a_body = imu_accel - accel_bias[None, :]  # (M, 3)
    a_world_nog = jnp.einsum("ij,mjk,mk->mi", R_start, C, a_body)  # R_k a_body
    a_world = a_world_nog + gravity_W[None, :].astype(dtype)

    # v_k (exclusive cumsum of impulses), then p_end in closed form.
    impulse = a_world * dt_eff[:, None]  # (M, 3)
    v_incl = jnp.cumsum(impulse, axis=0)
    v_excl = v_incl - impulse  # v_k before sample k's impulse
    v_end = v_incl[-1]
    p_end = jnp.sum(v_excl * dt_eff[:, None] + 0.5 * a_world * (dt_eff * dt_eff)[:, None], axis=0)

    delta_R = P[-1]  # R_start^T R_end = product of all dRs
    rotvec_delta = se3.so3_log(delta_R)

    # World-frame integrals -> start-body frame (imu_preintegration.py:123-143).
    p_body = R_start.T @ p_end
    v_body = R_start.T @ v_end
    delta_pose = jnp.concatenate([p_body, rotvec_delta])

    dt_sum = jnp.sum(dt_eff)
    denom = jnp.maximum(dt_sum, 1e-12)
    return PreintResult(
        delta_pose=delta_pose,
        delta_R=delta_R,
        delta_p=p_body,
        delta_v=v_body,
        ess=jnp.sum(weights),
        a_body_mean=jnp.sum(a_body * dt_eff[:, None], axis=0) / denom,
        a_world_nog_mean=jnp.sum(a_world_nog * dt_eff[:, None], axis=0) / denom,
        a_world_mean=jnp.sum(a_world * dt_eff[:, None], axis=0) / denom,
        dt_eff_sum=dt_sum,
    )


def imu_integration_time(
    imu_stamps: jnp.ndarray, t_start: jnp.ndarray, t_end: jnp.ndarray
) -> jnp.ndarray:
    """dt_int = sum of IMU sample intervals inside (t_start, t_end].

    In-graph equivalent of the reference's host-side computation
    (backend/pipeline.py:262-313): stamps are time-sorted, so the interval
    sum telescopes to (max_valid - min_valid); invariants 0 <= dt_int <=
    t_end - t_start; zero when fewer than 2 valid samples.
    """
    eps = 1e-9
    valid = (imu_stamps > t_start - eps) & (imu_stamps <= t_end + eps) & (imu_stamps > 0.0)
    n_valid = jnp.sum(valid)
    big = jnp.asarray(1e30, dtype=imu_stamps.dtype)
    t_max = jnp.max(jnp.where(valid, imu_stamps, -big))
    t_min = jnp.min(jnp.where(valid, imu_stamps, big))
    dt_int = jnp.clip(t_max - t_min, 0.0, jnp.maximum(t_end - t_start, 0.0))
    from gcslam_tpu.utils.xla import BELIEF_DTYPE
    return jnp.where(n_valid >= 2, dt_int, 0.0).astype(BELIEF_DTYPE)


def imu_mean_sample_period(imu_stamps: jnp.ndarray) -> jnp.ndarray:
    """Average IMU sampling period over nonzero (valid) stamps
    (backend/pipeline.py:525-534); floored at 1e-12."""
    valid = imu_stamps > 0.0
    n = jnp.sum(valid)
    big = jnp.asarray(1e30, dtype=imu_stamps.dtype)
    t_max = jnp.max(jnp.where(valid, imu_stamps, -big))
    t_min = jnp.min(jnp.where(valid, imu_stamps, big))
    dt = jnp.where(n >= 2, (t_max - t_min) / jnp.maximum(n - 1, 1), 0.0)
    from gcslam_tpu.utils.xla import BELIEF_DTYPE
    return jnp.maximum(dt, 1e-12).astype(BELIEF_DTYPE)
