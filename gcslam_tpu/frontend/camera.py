"""Camera feature extraction + depth evidence — the visual frontend.

Covers the functionality of the reference's C++ nodes + host libraries:
  - visual_feature_node.cpp:63-653 (ORB detect -> robust depth sampling ->
    local quadratic depth-surface fit -> closed-form 3x3 backprojection
    covariance -> Student-t reliability -> per-feature depth natural params
    (Lambda_c, theta_c), vMF appearance, color) and
  - frontend/sensors/lidar_camera_depth_fusion.py:99-489 (LiDAR->camera
    depth evidence: Route A image-space robust sampling + Route B ray-plane
    intersection) and sensors/splat_prep.py:37 (PoE fusion
    Lambda_f = Lambda_c + Lambda_l).

Array-program redesign: corner detection is HARRIS VIA CONVOLUTIONS (Sobel
+ box filters -> response map -> 3x3 max-pool NMS -> top-K), which XLA
fuses into a few device kernels, instead of CPU ORB pyramids; descriptors are replaced by the
vMF appearance lobe the pipeline actually consumes (the reference's ORB
descriptors are never matched — association is geometric OT). Fixed N_FEAT
budget with validity masks; everything jittable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

from gcslam_tpu.utils.xla import jax, jnp, BELIEF_DTYPE, POINT_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.ops import linalg


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def K(self):
        import numpy as np

        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])


class CameraFeatures(NamedTuple):
    """Fixed-budget camera feature set (the VisualFeatureBatch analog)."""

    uv: jnp.ndarray  # (N_FEAT, 2) pixel coords
    depth: jnp.ndarray  # (N_FEAT,) fused depth (m)
    Lambdas: jnp.ndarray  # (N_FEAT, 3, 3) 3D info-form precision (camera frame)
    thetas: jnp.ndarray  # (N_FEAT, 3)
    etas: jnp.ndarray  # (N_FEAT, B, 3) vMF appearance lobes
    weights: jnp.ndarray  # (N_FEAT,) reliability
    colors: jnp.ndarray  # (N_FEAT, 3)
    valid: jnp.ndarray  # (N_FEAT,) bool


def _conv2(img: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Same-padding 2D convolution of (H, W) with (kh, kw)."""
    return jax.lax.conv_general_dilated(
        img[None, None], k[None, None].astype(img.dtype),
        window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


def harris_corners(gray: jnp.ndarray, n_feat: int, k: float = 0.04,
                   nms_radius: int = 2) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Harris corner detection, fully convolutional.

    Returns (uv (n_feat, 2) float, score (n_feat,), valid (n_feat,) bool).
    """
    f32 = POINT_DTYPE
    g = gray.astype(f32)
    sobel_x = jnp.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=f32) / 8.0
    sobel_y = sobel_x.T
    Ix = _conv2(g, sobel_x)
    Iy = _conv2(g, sobel_y)
    box = jnp.ones((5, 5), dtype=f32) / 25.0
    Sxx = _conv2(Ix * Ix, box)
    Syy = _conv2(Iy * Iy, box)
    Sxy = _conv2(Ix * Iy, box)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    R = det - k * tr * tr

    # 3x3 (or (2r+1)^2) max-pool NMS: keep strict local maxima.
    w = 2 * nms_radius + 1
    Rmax = jax.lax.reduce_window(
        R, -jnp.inf, jax.lax.max, (w, w), (1, 1), "SAME"
    )
    is_peak = (R >= Rmax) & (R > 0)
    # suppress a border band (patch ops need margins)
    H, W = R.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    margin = 4
    inb = (ys >= margin) & (ys < H - margin) & (xs >= margin) & (xs < W - margin)
    score = jnp.where(is_peak & inb, R, -jnp.inf)

    flat = score.reshape(-1)
    top, idx = jax.lax.top_k(flat, n_feat)
    v = idx // W
    u = idx % W
    valid = jnp.isfinite(top) & (top > 0)
    uv = jnp.stack([u, v], axis=-1).astype(f32)
    return uv, jnp.where(valid, top, 0.0), valid


def _gather_patch(img: jnp.ndarray, uv: jnp.ndarray, r: int) -> jnp.ndarray:
    """(n, (2r+1)^2) patches around integer uv (clamped)."""
    H, W = img.shape
    du = jnp.arange(-r, r + 1)
    dv = jnp.arange(-r, r + 1)
    uu = jnp.clip(uv[:, 0, None, None].astype(jnp.int32) + du[None, None, :], 0, W - 1)
    vv = jnp.clip(uv[:, 1, None, None].astype(jnp.int32) + dv[None, :, None], 0, H - 1)
    return img[vv, uu].reshape(uv.shape[0], -1)


def depth_plane_fit(depth: jnp.ndarray, uv: jnp.ndarray, r: int = 2,
                    eps: float = 1e-9) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Local weighted plane fit z(u, v) = a du + b dv + c on a (2r+1)^2 patch.

    Returns (z_fit (n,), grad (n, 2) = (a, b), resid_var (n,)). Invalid/zero
    depths get zero weight (the reference's robust median/hex-ring sampling,
    visual_feature_node.cpp:228-401, replaced by one weighted LS).
    """
    n = uv.shape[0]
    w_side = 2 * r + 1
    patch = _gather_patch(depth, uv, r)  # (n, P)
    du = jnp.tile(jnp.arange(-r, r + 1, dtype=patch.dtype), w_side)
    dv = jnp.repeat(jnp.arange(-r, r + 1, dtype=patch.dtype), w_side)
    w = (patch > 0).astype(patch.dtype)  # invalid depth = 0

    # design matrix per patch: [du, dv, 1]
    A = jnp.stack([jnp.broadcast_to(du, patch.shape),
                   jnp.broadcast_to(dv, patch.shape),
                   jnp.ones_like(patch)], axis=-1)  # (n, P, 3)
    AtWA = jnp.einsum("npi,np,npj->nij", A, w, A) + eps * jnp.eye(3, dtype=patch.dtype)
    AtWz = jnp.einsum("npi,np,np->ni", A, w, patch)
    coef = linalg.solve3x3(AtWA, AtWz)  # (n, 3) = (a, b, c)
    z_fit = coef[:, 2]
    resid = patch - jnp.einsum("npi,ni->np", A, coef)
    m = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    resid_var = jnp.sum(w * resid * resid, axis=1) / m
    return z_fit, coef[:, :2], resid_var


def backprojection_covariance(
    uv: jnp.ndarray, z: jnp.ndarray, sigma_z_sq: jnp.ndarray,
    intr: PinholeIntrinsics, sigma_px: float = 0.7,
) -> jnp.ndarray:
    """Closed-form 3x3 covariance of p = z K^{-1} (u, v, 1)
    (reference visual_feature_node.cpp:450-489): Sigma = J diag(s_px^2,
    s_px^2, s_z^2) J^T with J = d p / d (u, v, z)."""
    x = (uv[:, 0] - intr.cx) / intr.fx
    y = (uv[:, 1] - intr.cy) / intr.fy
    zero = jnp.zeros_like(z)
    J = jnp.stack(
        [
            jnp.stack([z / intr.fx, zero, x], -1),
            jnp.stack([zero, z / intr.fy, y], -1),
            jnp.stack([zero, zero, jnp.ones_like(z)], -1),
        ],
        axis=-2,
    )  # (n, 3, 3)
    D = jnp.stack([jnp.full_like(z, sigma_px**2), jnp.full_like(z, sigma_px**2), sigma_z_sq], -1)
    return jnp.einsum("nij,nj,nkj->nik", J, D, J)


def backproject(uv: jnp.ndarray, z: jnp.ndarray, intr: PinholeIntrinsics) -> jnp.ndarray:
    x = (uv[:, 0] - intr.cx) / intr.fx
    y = (uv[:, 1] - intr.cy) / intr.fy
    return jnp.stack([x * z, y * z, z], axis=-1)


# ---------------------------------------------------------------------------
# LiDAR -> camera depth evidence (Route A + Route B) and PoE fusion
# ---------------------------------------------------------------------------


def lidar_depth_evidence(
    uv: jnp.ndarray,  # (n, 2) feature pixels
    lidar_cam: jnp.ndarray,  # (M, 3) LiDAR points in CAMERA frame
    lidar_w: jnp.ndarray,  # (M,)
    intr: PinholeIntrinsics,
    radius_px: float = 6.0,
    eps: float = 1e-9,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-feature LiDAR depth evidence (lambda_z, z_l): continuous-weight
    fusion of the reference's two routes (lidar_camera_depth_fusion.py):

      Route A — project LiDAR into the image; Gaussian-weight points by
      pixel distance to the feature; robust (MAD-downweighted) mean depth.
      Route B — weighted local plane fit of the SAME neighborhood in 3D,
      intersected with the feature ray.

    Both produce (depth, precision); evidence adds (PoE). Features with no
    LiDAR support get lambda -> 0 continuously (never a gate)."""
    z = jnp.maximum(lidar_cam[:, 2], eps)
    u_l = intr.fx * lidar_cam[:, 0] / z + intr.cx
    v_l = intr.fy * lidar_cam[:, 1] / z + intr.cy
    in_front = (lidar_cam[:, 2] > 0.1).astype(lidar_cam.dtype) * lidar_w

    d2 = (uv[:, 0:1] - u_l[None, :]) ** 2 + (uv[:, 1:2] - v_l[None, :]) ** 2  # (n, M)
    w_px = jnp.exp(-0.5 * d2 / radius_px**2) * in_front[None, :]

    # Route A: robust weighted depth
    wsum = jnp.sum(w_px, axis=1) + eps
    z_mean = w_px @ z / wsum
    dev = jnp.abs(z[None, :] - z_mean[:, None])
    mad = (w_px * dev).sum(1) / wsum + 1e-3
    w_rob = w_px / (1.0 + (dev / (1.4826 * mad[:, None])) ** 2)
    wsum_r = jnp.sum(w_rob, axis=1) + eps
    z_a = w_rob @ z / wsum_r
    var_a = jnp.maximum((w_rob @ (z * z)) / wsum_r - z_a**2, 1e-6)  # E[z^2]-E[z]^2
    lam_a = wsum_r / (wsum_r + 1.0) / var_a  # support-scaled precision

    # Route B: plane fit p.n = d of the neighborhood; depth where the
    # feature ray ((x, y, 1) z) crosses the plane.
    x_r = (uv[:, 0] - intr.cx) / intr.fx
    y_r = (uv[:, 1] - intr.cy) / intr.fy
    mean_p = (w_rob @ lidar_cam) / wsum_r[:, None]  # (n, 3)
    diff = lidar_cam[None, :, :] - mean_p[:, None, :]
    cov = jnp.einsum("nm,nmi,nmj->nij", w_rob, diff, diff) / wsum_r[:, None, None]
    cov = linalg.sym(cov) + 1e-6 * jnp.eye(3, dtype=cov.dtype)
    evals, evecs = linalg.eigh_3x3(cov)
    n_pl = evecs[:, :, 0]
    d_pl = jnp.einsum("ni,ni->n", n_pl, mean_p)
    denom = n_pl[:, 0] * x_r + n_pl[:, 1] * y_r + n_pl[:, 2]
    z_b = d_pl / jnp.where(jnp.abs(denom) > 1e-3, denom, 1e-3)
    planarity = 1.0 - evals[:, 0] / (evals[:, 2] + eps)  # 1 = perfectly planar
    z_b_ok = (z_b > 0.1) & (jnp.abs(denom) > 1e-2)
    lam_b = jnp.where(z_b_ok, planarity * wsum_r / (wsum_r + 1.0) / jnp.maximum(evals[:, 0], 1e-6), 0.0)

    # PoE of the two routes
    lam = lam_a + lam_b
    z_f = (lam_a * z_a + lam_b * jnp.where(z_b_ok, z_b, 0.0)) / (lam + eps)
    return lam, z_f


def extract_camera_features(
    gray: jnp.ndarray,  # (H, W) float
    depth: jnp.ndarray,  # (H, W) float meters, 0 = invalid
    rgb: jnp.ndarray,  # (H, W, 3) float [0, 1]
    intr: PinholeIntrinsics,
    lidar_cam: jnp.ndarray | None = None,  # (M, 3) points in camera frame
    lidar_w: jnp.ndarray | None = None,
    n_feat: int = C.N_FEAT,
) -> CameraFeatures:
    """Full visual frontend: corners -> camera depth + covariance -> LiDAR
    depth evidence -> PoE fusion -> 3D Gaussian info form + vMF appearance."""
    f = BELIEF_DTYPE
    uv, score, valid = harris_corners(gray, n_feat)

    z_cam, grad, resid_var = depth_plane_fit(depth, uv)
    z_valid = z_cam > 0.05
    sigma_z_sq = resid_var + (0.0025 * z_cam**2) ** 1.0 + 1e-6  # stereo-like growth

    lam_z_cam = jnp.where(z_valid, 1.0 / sigma_z_sq, 0.0)
    if lidar_cam is not None:
        lam_z_l, z_l = lidar_depth_evidence(
            uv, lidar_cam.astype(POINT_DTYPE),
            (lidar_w if lidar_w is not None else jnp.ones(lidar_cam.shape[0])).astype(POINT_DTYPE),
            intr,
        )
        lam_z_l = lam_z_l.astype(gray.dtype)
        z_l = z_l.astype(gray.dtype)
    else:
        lam_z_l = jnp.zeros_like(z_cam)
        z_l = jnp.zeros_like(z_cam)

    # PoE depth fusion (splat_prep.py:37): lambda_f = lambda_c + lambda_l.
    lam_f = lam_z_cam + lam_z_l
    z_f = (lam_z_cam * z_cam + lam_z_l * z_l) / (lam_f + 1e-12)
    has_depth = lam_f > 1e-6
    z_f = jnp.where(has_depth, z_f, 1.0)

    Sigma = backprojection_covariance(uv, z_f, 1.0 / (lam_f + 1e-12), intr)
    Lam = linalg.inv3x3(Sigma.astype(f), eps=1e-9)
    p_cam = backproject(uv, z_f, intr).astype(f)
    theta = jnp.einsum("nij,nj->ni", Lam, p_cam)

    # vMF appearance: lobe 0 along the viewing ray, kappa from corner score
    # saturation (the reference's ORB descriptor is replaced by this lobe —
    # association only consumes directions/kappas).
    ray = p_cam / (jnp.linalg.norm(p_cam, axis=-1, keepdims=True) + 1e-12)
    kappa_app = 5.0 * score / (score + jnp.mean(score) + 1e-12)
    etas = jnp.zeros((n_feat, C.VMF_N_LOBES, 3), dtype=f)
    etas = etas.at[:, 0, :].set(kappa_app[:, None] * ray)

    # colors from the rgb image at the corner
    ui = jnp.clip(uv[:, 0].astype(jnp.int32), 0, rgb.shape[1] - 1)
    vi = jnp.clip(uv[:, 1].astype(jnp.int32), 0, rgb.shape[0] - 1)
    colors = rgb[vi, ui].astype(f)

    ok = valid & has_depth
    weights = jnp.where(ok, score / (score + jnp.mean(score) + 1e-12), 0.0).astype(f)
    okf = ok.astype(f)
    return CameraFeatures(
        uv=uv.astype(f),
        depth=z_f.astype(f),
        Lambdas=Lam * okf[:, None, None],
        thetas=theta * okf[:, None],
        etas=etas * okf[:, None, None],
        weights=weights,
        colors=colors,
        valid=ok,
    )


def extract_camera_features_native(
    gray: "np.ndarray",  # (H, W) float [0,1] or uint8
    depth: "np.ndarray",  # (H, W) float meters, 0 = invalid
    rgb: "np.ndarray",  # (H, W, 3) float [0,1]
    intr: PinholeIntrinsics,
    lidar_cam=None,
    lidar_w=None,
    n_feat: int = C.N_FEAT,
) -> "CameraFeatures | None":
    """Native fast path: corner detection + robust depth + plane fit run in
    C++ (native/gcslam_native.cpp gcslam_visual_features — the reference's
    src/visual_feature_node.cpp stage), then the Gaussian/vMF lifting reuses
    the same JAX ops as the pure path. Returns None when the native library
    is unavailable (callers fall back to extract_camera_features)."""
    import numpy as np
    from gcslam_tpu.frontend import native as native_mod

    g8 = np.asarray(gray)
    if g8.dtype != np.uint8:
        g8 = np.clip(np.asarray(gray, dtype=np.float64) * 255.0, 0, 255).astype(np.uint8)
    out = native_mod.visual_features(g8, np.asarray(depth, np.float32), max_feat=n_feat)
    if out is None:
        return None
    n, uv_n, score_n, z_n, zvar_n, _normal, _gray01 = out

    f = BELIEF_DTYPE
    uv = jnp.zeros((n_feat, 2), dtype=f).at[:n].set(jnp.asarray(uv_n[:n], dtype=f))
    score = jnp.zeros((n_feat,), dtype=f).at[:n].set(jnp.asarray(score_n[:n], dtype=f))
    z_cam = jnp.zeros((n_feat,), dtype=f).at[:n].set(jnp.asarray(z_n[:n], dtype=f))
    resid_var = jnp.ones((n_feat,), dtype=f).at[:n].set(jnp.asarray(zvar_n[:n], dtype=f))
    valid = jnp.zeros((n_feat,), dtype=bool).at[:n].set(True)

    z_valid = z_cam > 0.05
    sigma_z_sq = resid_var + (0.0025 * z_cam**2) + 1e-6
    lam_z_cam = jnp.where(z_valid, 1.0 / sigma_z_sq, 0.0)
    if lidar_cam is not None:
        lam_z_l, z_l = lidar_depth_evidence(
            uv, jnp.asarray(lidar_cam, dtype=POINT_DTYPE),
            jnp.asarray(lidar_w if lidar_w is not None else jnp.ones(len(lidar_cam)),
                        dtype=POINT_DTYPE),
            intr,
        )
        lam_z_l = lam_z_l.astype(f)
        z_l = z_l.astype(f)
    else:
        lam_z_l = jnp.zeros_like(z_cam)
        z_l = jnp.zeros_like(z_cam)

    lam_f = lam_z_cam + lam_z_l
    z_f = (lam_z_cam * z_cam + lam_z_l * z_l) / (lam_f + 1e-12)
    has_depth = lam_f > 1e-6
    z_f = jnp.where(has_depth, z_f, 1.0)

    Sigma = backprojection_covariance(uv, z_f, 1.0 / (lam_f + 1e-12), intr)
    Lam = linalg.inv3x3(Sigma.astype(f), eps=1e-9)
    p_cam = backproject(uv, z_f, intr).astype(f)
    theta = jnp.einsum("nij,nj->ni", Lam, p_cam)

    ray = p_cam / (jnp.linalg.norm(p_cam, axis=-1, keepdims=True) + 1e-12)
    kappa_app = 5.0 * score / (score + jnp.mean(score) + 1e-12)
    etas = jnp.zeros((n_feat, C.VMF_N_LOBES, 3), dtype=f)
    etas = etas.at[:, 0, :].set(kappa_app[:, None] * ray)

    import numpy as _np
    rgbn = _np.asarray(rgb)
    ui = _np.clip(_np.asarray(uv[:, 0], dtype=int), 0, rgbn.shape[1] - 1)
    vi = _np.clip(_np.asarray(uv[:, 1], dtype=int), 0, rgbn.shape[0] - 1)
    colors = jnp.asarray(rgbn[vi, ui], dtype=f)

    ok = valid & has_depth
    weights = jnp.where(ok, score / (score + jnp.mean(score) + 1e-12), 0.0).astype(f)
    okf = ok.astype(f)
    return CameraFeatures(
        uv=uv, depth=z_f.astype(f),
        Lambdas=Lam * okf[:, None, None],
        thetas=theta * okf[:, None],
        etas=etas * okf[:, None, None],
        weights=weights, colors=colors, valid=ok,
    )


def features_to_base_frame(feats: CameraFeatures, T_base_cam: jnp.ndarray) -> CameraFeatures:
    """Transform the camera-frame Gaussians/lobes into the base frame
    (cam batch slice is consumed in base coordinates)."""
    from gcslam_tpu.ops import se3

    R = se3.so3_exp(jnp.asarray(T_base_cam[3:6], dtype=BELIEF_DTYPE))
    t = jnp.asarray(T_base_cam[:3], dtype=BELIEF_DTYPE)
    Lam_b = jnp.einsum("ij,njk,lk->nil", R, feats.Lambdas, R)
    mu_c = linalg.solve3x3(feats.Lambdas, feats.thetas, eps=1e-9)
    mu_b = mu_c @ R.T + t[None, :]
    theta_b = jnp.einsum("nij,nj->ni", Lam_b, mu_b)
    eta_b = jnp.einsum("ij,nbj->nbi", R, feats.etas)
    okf = feats.valid.astype(Lam_b.dtype)
    return feats._replace(
        Lambdas=Lam_b * okf[:, None, None], thetas=theta_b * okf[:, None], etas=eta_b
    )
