"""Batched, branch-free SO(3)/SE(3) Lie ops for one jitted device program.

Semantics match the reference (fl_slam_poc/common/geometry/se3_jax.py:44-539):
6D pose = [trans(3), rotvec(3)]; small-angle Taylor blends via jnp.where;
deterministic near-pi handling through a softmax-weighted diagonal-axis
extraction in so3_log (reference se3_jax.py:341-357).

Differences from the reference:
  - every function broadcasts over arbitrary leading batch dims (no per-call
    `.reshape(-1)`, no forced f64 casts — dtype follows the input), so the
    whole pipeline can run in f32 for bulk data and f64 for belief algebra;
  - no per-function `@jit` (these are always called inside the one jitted
    scan step; jitting per-op only fragments the program).
"""

from __future__ import annotations

from gcslam_tpu.utils.xla import jax, jnp

SMALL_ANGLE = 1e-7
NEAR_PI = 1e-7


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """[v]x for (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of skew for (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _theta(phi: jnp.ndarray):
    theta_sq = jnp.sum(phi * phi, axis=-1)
    return jnp.sqrt(theta_sq), theta_sq


def _eye3_like(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.eye(3, dtype=x.dtype)


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) rotvec -> (..., 3, 3) rotation."""
    theta, theta_sq = _theta(omega)
    K = skew(omega)
    K_sq = K @ K
    safe_t = jnp.where(theta < SMALL_ANGLE, 1.0, theta)
    safe_t2 = jnp.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    A = jnp.where(theta < SMALL_ANGLE, 1.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(theta < SMALL_ANGLE, 0.5, (1.0 - jnp.cos(safe_t)) / safe_t2)
    I = _eye3_like(omega)
    return I + A[..., None, None] * K + B[..., None, None] * K_sq


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3) rotvec.

    Branch-free small-angle / generic / near-pi blend. Near pi, the axis is a
    softmax mixture of the columns of (R + I) — same smooth heuristic as the
    reference (se3_jax.py:341-357), avoiding a hard argmax.
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0)
    vex = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # theta = atan2(||vex||, cos_theta): well-conditioned everywhere except
    # exactly at pi (where the near-pi axis extraction takes over). This is
    # numerically tighter than the reference's arccos-of-trace.
    sin_theta = jnp.linalg.norm(vex, axis=-1)
    theta = jnp.arctan2(sin_theta, cos_theta)

    omega_small = vex
    safe_sin = jnp.where(sin_theta < SMALL_ANGLE, 1.0, sin_theta)
    omega_general = (theta / safe_sin)[..., None] * vex

    # Near pi: recover a a^T exactly from the symmetric part,
    #   S = (R + R^T)/2 = cos(theta) I + (1 - cos(theta)) a a^T,
    # then take a smooth (softmax-weighted) combination of its columns —
    # every column of a a^T is collinear with a. This is second-order
    # accurate (no O(pi - theta) axis error), tighter than the reference's
    # columns-of-(R+I) heuristic (se3_jax.py:341-357).
    S_sym = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    one_minus_c = jnp.maximum(1.0 - cos_theta, SMALL_ANGLE)[..., None, None]
    outer = (S_sym - cos_theta[..., None, None] * _eye3_like(tr[..., None])) / one_minus_c
    diag = jnp.diagonal(outer, axis1=-2, axis2=-1)  # = a_i^2
    w = jax.nn.softmax(50.0 * diag, axis=-1)  # favor the dominant column smoothly
    axis_col = jnp.einsum("...j,...ij->...i", w, outer)
    axis_norm = jnp.linalg.norm(axis_col, axis=-1, keepdims=True)
    safe_norm = jnp.where(axis_norm < SMALL_ANGLE, 1.0, axis_norm)
    axis = axis_col / safe_norm
    # Sign convention: align with vex (continuity with the general branch);
    # at exactly pi both signs produce the same R.
    sign = jnp.where(jnp.sum(axis * vex, axis=-1, keepdims=True) >= 0.0, 1.0, -1.0)
    omega_pi = axis * sign * theta[..., None]

    is_small = (theta < SMALL_ANGLE)[..., None]
    is_near_pi = ((cos_theta < 0.0) & (sin_theta < 1e-5))[..., None]
    return jnp.where(is_small, omega_small, jnp.where(is_near_pi, omega_pi, omega_general))


def _BC_coeffs(theta, theta_sq):
    """B = (1-cos)/t^2, C = (t-sin)/t^3 with Taylor continuation."""
    safe_t = jnp.where(theta < SMALL_ANGLE, 1.0, theta)
    safe_t2 = jnp.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    safe_t3 = safe_t2 * safe_t
    B = jnp.where(theta < SMALL_ANGLE, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(safe_t)) / safe_t2)
    C = jnp.where(
        theta < SMALL_ANGLE, 1.0 / 6.0 - theta_sq / 120.0, (safe_t - jnp.sin(safe_t)) / safe_t3
    )
    return B, C


def so3_right_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Jr(phi) = I - B [phi]x + C [phi]x^2 (reference se3_jax.py:68-103)."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return _eye3_like(phi) - B[..., None, None] * K + C[..., None, None] * (K @ K)


def so3_right_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Jr^{-1}(phi) = I + 1/2 [phi]x + D [phi]x^2 (reference se3_jax.py:107-134)."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    eps = 1e-12
    denom = 2.0 * theta * jnp.sin(theta) + eps
    D = jnp.where(
        theta < 1e-4,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / (theta_sq + eps) - (1.0 + jnp.cos(theta)) / denom,
    )
    return _eye3_like(phi) + 0.5 * K + D[..., None, None] * (K @ K)


def se3_V(phi: jnp.ndarray) -> jnp.ndarray:
    """V(phi) mapping rho -> t in Exp([rho; phi])."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    B, C = _BC_coeffs(theta, theta_sq)
    return _eye3_like(phi) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def se3_V_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Closed-form V^{-1}(phi) = I - 1/2 [phi]x + D [phi]x^2."""
    theta, theta_sq = _theta(phi)
    K = skew(phi)
    eps = 1e-12
    safe_t = jnp.where(theta < SMALL_ANGLE, 1.0, theta)
    safe_t2 = jnp.where(theta_sq < SMALL_ANGLE**2, 1.0, theta_sq)
    denom = 2.0 * safe_t * jnp.sin(safe_t) + eps
    D = jnp.where(
        theta < SMALL_ANGLE,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / safe_t2 - (1.0 + jnp.cos(safe_t)) / denom,
    )
    return _eye3_like(phi) - 0.5 * K + D[..., None, None] * (K @ K)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) twist [rho(3), phi(3)] -> 6D pose [t, rotvec] with t = V(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    t = jnp.einsum("...ij,...j->...i", se3_V(phi), rho)
    return jnp.concatenate([t, phi], axis=-1)


def se3_log(pose: jnp.ndarray) -> jnp.ndarray:
    """6D pose [t, rotvec] -> twist [rho, phi]; rho = V^{-1}(phi) t.

    Rotation is canonicalized via Log(Exp(rotvec)) for robustness near pi,
    matching reference se3_jax.py:244-256.
    """
    t, rotvec = pose[..., :3], pose[..., 3:6]
    phi = so3_log(so3_exp(rotvec))
    rho = jnp.einsum("...ij,...j->...i", se3_V_inv(phi), t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """T_a ∘ T_b for 6D poses [t, rotvec]."""
    Ra = so3_exp(a[..., 3:6])
    Rb = so3_exp(b[..., 3:6])
    t = a[..., :3] + jnp.einsum("...ij,...j->...i", Ra, b[..., :3])
    rotvec = so3_log(Ra @ Rb)
    return jnp.concatenate([t, rotvec], axis=-1)


def se3_inverse(a: jnp.ndarray) -> jnp.ndarray:
    R = so3_exp(a[..., 3:6])
    R_inv = jnp.swapaxes(R, -1, -2)
    t_inv = -jnp.einsum("...ij,...j->...i", R_inv, a[..., :3])
    return jnp.concatenate([t_inv, so3_log(R_inv)], axis=-1)


def se3_relative(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """b^{-1} ∘ a (reference se3_jax.py:457-459)."""
    return se3_compose(se3_inverse(b), a)


def se3_plus(x: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Retraction: T(x) ∘ T(delta) where delta is a 6D pose increment."""
    return se3_compose(x, delta)


def se3_minus(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """delta such that x2 ⊕ delta = x1 (pose-difference, not twist)."""
    return se3_relative(x1, x2)


def se3_adjoint(xi: jnp.ndarray) -> jnp.ndarray:
    """Ad_T (6x6) for pose [t, rotvec] acting on twists [rho, phi]:

        Ad = [[R, [t]x R], [0, R]]   so that   Exp(Ad_T xi) = T Exp(xi) T^{-1}.
    """
    t = xi[..., :3]
    R = so3_exp(xi[..., 3:6])
    tR = skew(t) @ R
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([Z, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_cov_compose(cov_a: jnp.ndarray, cov_b: jnp.ndarray, T_a: jnp.ndarray) -> jnp.ndarray:
    """Compose covariances under T_out = T_a ∘ T_b."""
    Ad = se3_adjoint(T_a)
    return cov_a + Ad @ cov_b @ jnp.swapaxes(Ad, -1, -2)


def se3_identity(dtype=None) -> jnp.ndarray:
    from gcslam_tpu.utils.xla import BELIEF_DTYPE

    return jnp.zeros(6, dtype=dtype or BELIEF_DTYPE)


def apply_pose_to_points(pose: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """p' = R p + t for pose (..., 6) and points (..., N, 3)."""
    R = so3_exp(pose[..., 3:6])
    t = pose[..., :3]
    return jnp.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]
