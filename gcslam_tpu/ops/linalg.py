"""Branch-free total-function numeric kernels (reference common/primitives.py:80-533).

Every function always executes its stabilization (symmetrize, eigenvalue
floor, lift) and returns the magnitude of the change as a certificate scalar.
All functions broadcast over leading batch dims and are designed to live
inside one jitted program (no per-op jit, no host syncs, no Python floats).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from gcslam_tpu.utils.xla import jax, jnp
from gcslam_tpu import constants as C


class PsdCert(NamedTuple):
    """Numeric certificate of a PSD projection (cf. reference cert_vec,
    common/primitives.py:119-123)."""

    projection_delta: jnp.ndarray
    sym_delta: jnp.ndarray
    eig_min: jnp.ndarray
    eig_max: jnp.ndarray
    cond: jnp.ndarray
    near_null_count: jnp.ndarray


def sym(M: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def domain_projection_psd(
    M: jnp.ndarray, eps_psd: float = C.EPS_PSD
) -> Tuple[jnp.ndarray, PsdCert]:
    """Symmetrize + eigh + eigenvalue floor + reconstruct. Always applied."""
    M_sym = sym(M)
    sym_delta = jnp.linalg.norm(M_sym - M, axis=(-2, -1))
    # 3x3 blocks (most call sites: evidence factors, IW suffstats) use the
    # analytic Jacobi kernel — XLA's general eigh expansion at every call
    # site was the single largest compile cost (see eigh_3x3).
    if M.shape[-1] == 3:
        eigvals, eigvecs = eigh_3x3(M_sym)
    else:
        eigvals, eigvecs = jnp.linalg.eigh(M_sym)
    vals = jnp.maximum(eigvals, eps_psd)
    M_psd = jnp.einsum("...ik,...k,...jk->...ij", eigvecs, vals, eigvecs)
    projection_delta = jnp.linalg.norm(M_psd - M_sym, axis=(-2, -1))
    eig_min = jnp.min(vals, axis=-1)
    eig_max = jnp.max(vals, axis=-1)
    cert = PsdCert(
        projection_delta=projection_delta,
        sym_delta=sym_delta,
        eig_min=eig_min,
        eig_max=eig_max,
        cond=eig_max / eig_min,
        near_null_count=jnp.sum(vals < 10.0 * eps_psd, axis=-1).astype(M.dtype),
    )
    return M_psd, cert


def _lift_eps(L: jnp.ndarray, eps_lift: float) -> jnp.ndarray:
    """Effective Cholesky ridge: eps_lift plus a RELATIVE floor scaled by the
    matrix magnitude and the dtype's machine epsilon. A nominally-PSD matrix
    carries roundoff-negative eigenvalues of order eps_mach * ||L||; in
    f32-belief mode an absolute 1e-9 lift cannot cover them and cholesky
    returns NaN (observed on the near-zero coarse-round map factor). The
    relative term is ~1e-14 * ||L|| in f64 — far below eps_lift's effect."""
    diag_scale = jnp.max(
        jnp.abs(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    rel = 32.0 * jnp.finfo(L.dtype).eps * diag_scale
    return (eps_lift + rel)[..., None, None] if rel.ndim else eps_lift + rel


def spd_solve_lifted(
    L: jnp.ndarray, b: jnp.ndarray, eps_lift: float = C.EPS_LIFT
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """x = (L + eps I)^{-1} b via Cholesky; returns (x, lift_strength).

    Lift is ALWAYS applied (reference common/primitives.py:141-166).
    """
    d = L.shape[-1]
    if d == 3 and b.ndim == L.ndim - 1:
        # closed-form adjugate solve: compile-trivial vs a Cholesky expansion
        return solve3x3(L, b, eps=eps_lift), jnp.asarray(eps_lift * d, dtype=L.dtype)
    L_lifted = L + _lift_eps(L, eps_lift) * jnp.eye(d, dtype=L.dtype)
    chol = jnp.linalg.cholesky(L_lifted)
    b_vec = b[..., None] if b.ndim == L.ndim - 1 else b
    y = jax.scipy.linalg.solve_triangular(chol, b_vec, lower=True)
    x = jax.scipy.linalg.solve_triangular(jnp.swapaxes(chol, -1, -2), y, lower=False)
    if b.ndim == L.ndim - 1:
        x = x[..., 0]
    return x, jnp.asarray(eps_lift * d, dtype=L.dtype)


def spd_inverse_lifted(
    L: jnp.ndarray, eps_lift: float = C.EPS_LIFT
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(L + eps I)^{-1} via Cholesky; returns (L_inv, lift_strength).
    3x3 blocks use the closed-form adjugate inverse (symmetrized)."""
    d = L.shape[-1]
    if d == 3:
        return sym(inv3x3(L, eps=eps_lift)), jnp.asarray(eps_lift * d, dtype=L.dtype)
    L_lifted = L + _lift_eps(L, eps_lift) * jnp.eye(d, dtype=L.dtype)
    chol = jnp.linalg.cholesky(L_lifted)
    eye = jnp.broadcast_to(jnp.eye(d, dtype=L.dtype), L.shape)
    chol_inv = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    L_inv = jnp.swapaxes(chol_inv, -1, -2) @ chol_inv
    return L_inv, jnp.asarray(eps_lift * d, dtype=L.dtype)


def inv_mass(m: jnp.ndarray, eps_mass: float = C.EPS_MASS) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1/(m + eps) and the epsilon ratio; total even for m <= 0."""
    m = jnp.asarray(m)
    guard = jnp.finfo(m.dtype).eps
    denom = m + eps_mass + guard
    return 1.0 / denom, eps_mass / denom


def clamp(x: jnp.ndarray, lo: float, hi: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    clamped = jnp.clip(x, lo, hi)
    return clamped, jnp.abs(clamped - x)


def safe_normalize(v: jnp.ndarray, eps: float = C.EPS_MASS) -> Tuple[jnp.ndarray, jnp.ndarray]:
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    denom = norm + eps
    return v / denom, (eps / denom)[..., 0]


def _jacobi_rot_3x3(A: jnp.ndarray, V: jnp.ndarray, p: int, q: int):
    """One batched Jacobi rotation zeroing A[..., p, q] (static p < q).

    Fully algebraic (sqrt/divide only — no atan2/sin/cos)."""
    app = A[..., p, p]
    aqq = A[..., q, q]
    apq = A[..., p, q]
    # Overflow-free smaller-root rotation: t = sign(d) * 2 apq / (|d| + r)
    # with d = aqq - app, r = sqrt(d^2 + 4 apq^2). Entries are pre-normalized
    # to O(1) by eigh_3x3, so every intermediate is bounded ~[0, 4] — the
    # classic tau = d/(2 apq) form overflows for tiny apq, and that inf
    # turns into NaN in the rotation algebra.
    d = aqq - app
    r = jnp.sqrt(d * d + 4.0 * apq * apq)
    small = jnp.abs(apq) <= 1e-24 * (jnp.abs(app) + jnp.abs(aqq) + 1e-30)
    sgn_d = jnp.where(d >= 0.0, 1.0, -1.0)
    t = jnp.where(small, 0.0, sgn_d * 2.0 * apq / (jnp.abs(d) + r + 1e-300))
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    J = jnp.broadcast_to(jnp.eye(3, dtype=A.dtype), A.shape)
    J = J.at[..., p, p].set(c).at[..., q, q].set(c)
    J = J.at[..., p, q].set(s).at[..., q, p].set(-s)
    A_new = sym(jnp.swapaxes(J, -1, -2) @ A @ J)
    V_new = V @ J
    return A_new, V_new


def eigh_3x3(M: jnp.ndarray, n_sweeps: int = 6) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched symmetric 3x3 eigendecomposition via statically-unrolled
    cyclic Jacobi (ascending eigenvalues, like jnp.linalg.eigh).

    XLA's general eigh lowers to a large per-instance subgraph (or a solver
    library call) at each of ~30 call sites, which dominated compile time;
    this analytic kernel is ~18 fused elementwise steps — compile-trivial,
    batch-friendly (the surfel plane fit runs it on 8192 cells/scan), and
    free of transcendentals. 6 sweeps converge 3x3 to ~1e-15 relative."""
    A = sym(M)
    # Scale-normalize: Jacobi is scale-invariant, and O(1) entries keep the
    # rotation algebra inside the f32 exponent range (scatter matrices can
    # reach ~1e18 in f32-belief mode, where tau would overflow to inf-inf).
    scale = jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True)
    scale_safe = jnp.where(scale > 0.0, scale, 1.0)
    A = A / scale_safe
    V = jnp.broadcast_to(jnp.eye(3, dtype=M.dtype), M.shape)

    def sweep(_, AV):
        A, V = AV
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rot_3x3(A, V, p, q)
        return A, V

    # fori_loop keeps the HLO small (compile cost) while unroll=3 halves the
    # loop-boundary overhead — the body is ~18 fused elementwise steps, so
    # the while-loop boundary is a measurable fraction of each sweep.
    A, V = jax.lax.fori_loop(0, n_sweeps, sweep, (A, V), unroll=3)
    lam = jnp.diagonal(A, axis1=-2, axis2=-1) * scale_safe[..., 0]
    # Rank-based 3-element ordering: argsort over a width-3 axis still
    # lowers to a sort HLO (a real dispatch at every eigh_3x3 call site);
    # the comparison-count rank fuses into the surrounding elementwise
    # kernel. Tie-break by index matches argsort's stable order.
    # NaN caveat: every NaN eigenvalue compares false, gets
    # rank 0, and `order` then duplicates indices — unlike argsort, which
    # places NaNs last. Acceptable: NaN eigenvalues mean the input matrix
    # was already poisoned, and the certificate layer (non-finite triggers)
    # quarantines the scan before ordering details matter.
    i3 = jnp.arange(3)
    less = (lam[..., None, :] < lam[..., :, None]) | (
        (lam[..., None, :] == lam[..., :, None]) & (i3[None, :] < i3[:, None])
    )
    rank = jnp.sum(less, axis=-1)  # (..., 3) rank of element i
    order = jnp.argmax(rank[..., None, :] == i3[:, None], axis=-1)
    lam_sorted = jnp.take_along_axis(lam, order, axis=-1)
    V_sorted = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return lam_sorted, V_sorted


def softplus_positive(x: jnp.ndarray, eps: float = 1e-12, beta: float = 50.0) -> jnp.ndarray:
    """Smooth projection to (0, inf): softplus(beta x)/beta + eps
    (reference operators/inverse_wishart_jax.py:458-462)."""
    return jax.nn.softplus(beta * x) / beta + eps


def smooth_interval_project(x: jnp.ndarray, lo: jnp.ndarray, hi: float) -> jnp.ndarray:
    """Smooth projection of x into [lo, hi] via double softplus (no kinks),
    matching the reference nu-clipping (operators/inverse_wishart_jax.py:608-612)."""
    floored = lo + jax.nn.softplus(x - lo)
    return hi - jax.nn.softplus(hi - floored)


# ---------------------------------------------------------------------------
# Closed-form batched 3x3 kernels: adjugate-form inverse/solve is pure
# fused elementwise math, where a batched LU would be a library call per
# call site.
# ---------------------------------------------------------------------------


def det3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(M: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Adjugate inverse of (..., 3, 3); optional +eps*I lift before inverting.

    Scale-normalized (inv(M) = inv(M/s)/s with s = max|M|): cofactors and
    det stay O(1), so f32 never overflows (a diag(1e13) block overflows the
    raw det and silently inverted to ZERO) and the det floor is RELATIVE.
    The floor also preserves det's sign — replacing a tiny negative det
    with +tiny flipped the sign of the whole inverse. The relative ridge
    (dtype eps * scale) covers roundoff-indefinite inputs in f32-belief
    mode, mirroring _lift_eps for the Cholesky path."""
    s = jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True)
    s = jnp.where(s > 0.0, s, 1.0)
    eps_rel = 32.0 * jnp.finfo(M.dtype).eps
    M = M / s + (eps / s + eps_rel) * jnp.eye(3, dtype=M.dtype)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * Cc
    # Relative, SIGN-PRESERVING det floor (entries are O(1) here); 1e-30
    # also stays inside the f32 exponent range (f32-belief mode).
    floor = jnp.maximum(jnp.asarray(1e-30, dtype=M.dtype),
                        (32.0 * jnp.finfo(M.dtype).eps) ** 3)
    sgn = jnp.where(det >= 0.0, 1.0, -1.0)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > floor, det, sgn * floor)
    adjT = jnp.stack(
        [
            jnp.stack([A, D, G], axis=-1),
            jnp.stack([B, E, H], axis=-1),
            jnp.stack([Cc, F, I], axis=-1),
        ],
        axis=-2,
    )
    return adjT * (inv_det[..., None, None] / s)


def solve3x3(M: jnp.ndarray, b: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """x = M^{-1} b for (..., 3, 3) and (..., 3)."""
    return jnp.einsum("...ij,...j->...i", inv3x3(M, eps), b)


def rotation_from_scatter(S: jnp.ndarray):
    """Nearest proper rotation + singular spectrum of a 3x3 scatter matrix,
    built from eigh(S^T S) through the closed-form eigh_3x3 (no SVD/LU).

    Returns (R_star, D, V):
      R_star: (3, 3) proper rotation maximizing tr(S^T R)  (Kabsch mode)
      D: (3,) generalized singular values diag(U^T S V) — the last one
         carries the Kabsch sign, exactly what the Matrix-Fisher Laplace
         H = V (tr(D) I - D) V^T needs
      V: (3, 3) right singular vectors (det +1)
    """
    B = sym(jnp.swapaxes(S, -1, -2) @ S)
    lam, V = eigh_3x3(B)  # ascending
    # descending order
    lam = lam[..., ::-1]
    V = V[..., :, ::-1]
    # det(V) = +1
    detV = det3x3(V)
    V = V.at[..., :, 2].multiply(jnp.where(detV < 0, -1.0, 1.0))
    sigma = jnp.sqrt(jnp.maximum(lam, 0.0))
    floor = jnp.maximum(1e-9 * sigma[..., :1], 1e-20)  # f32-exponent-safe
    U_raw = S @ (V / jnp.maximum(sigma[..., None, :], floor))
    # Orthonormalize (rank-deficient S -> complete the frame right-handed).
    u1, _ = safe_normalize(U_raw[..., :, 0])
    u2_raw = U_raw[..., :, 1] - jnp.sum(u1 * U_raw[..., :, 1], -1, keepdims=True) * u1
    u2, _ = safe_normalize(u2_raw)
    u3 = jnp.cross(u1, u2)
    U = jnp.stack([u1, u2, u3], axis=-1)  # det +1 by construction
    R_star = U @ jnp.swapaxes(V, -1, -2)
    D = jnp.diagonal(jnp.swapaxes(U, -1, -2) @ S @ V, axis1=-2, axis2=-1)
    return R_star, D, V
