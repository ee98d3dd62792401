"""Primitive-alignment pose evidence (steps 7-8 output): the LiDAR/camera
pose factor from OT soft correspondences.

Parity map (reference operators/visual_pose_evidence.py:662-1024):
  - translation: weighted least squares over (meas, candidate) pairs,
        L_t = sum pi_ik Lambda_i,  residual r_ik = m_k - R p_i - t;
  - rotation: responsibility-weighted scatter S = sum pi sqrt(kappa kappa')
        m_hat_w m_hat_b^T, SVD -> nearest rotation, Laplace information.

Deviations (correctness; certified as 'linearization' triggers):
  - the information/vector pair is expressed in the CHART tangent frame
    (right perturbation X = X0 Exp(dxi)): the residual is rotated into the
    body/anchor frame, where the transported precision
    R^T (R Lambda_b R^T) R = Lambda_b — so the translation block keeps the
    reference's exact form while h gains the missing R^T and -t0 terms
    (the reference's h omits both, visual_pose_evidence.py:717-722);
  - the alignment factor is the FULL 6x6 pose Laplace with the
    translation-rotation lever-arm coupling A_i = [-I | [p_i]x] instead of
    the reference's decoupled translation-WLS; the [p]x columns carry the
    rotation information (~ lambda * lever^2) that lets the map correct
    heading against drifting absolute odometry;
  - rotation information uses the exact Matrix-Fisher Laplace
    H = V (tr(D) I - D) V^T at the SVD mode instead of diag(singular values)
    in the wrong basis, and the residual is the right-perturbation
    Log(R0^T R*) instead of the left one.
"""

from __future__ import annotations

from typing import Tuple

from gcslam_tpu.utils.xla import jnp, BELIEF_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.models.batch import MeasurementBatch, mean_positions, mean_directions, kappas
from gcslam_tpu.ops import linalg, se3
from gcslam_tpu.ops.certs import Cert, make_cert, TRIGGERS


def primitive_pose_evidence(
    assoc,  # AssociationResult
    batch: MeasurementBatch,
    view,  # AtlasView
    z_lin_pose: jnp.ndarray,  # (6,) world pose linearization point
    cfg,
    cands=None,  # association.CandidateSet: gather-free candidate attrs
) -> Tuple[jnp.ndarray, jnp.ndarray, Cert]:
    f = BELIEF_DTYPE
    t0 = z_lin_pose[:3]
    R0 = se3.so3_exp(z_lin_pose[3:6])

    meas_pos = mean_positions(batch, cfg.eps_lift)  # (N, 3) body
    meas_dir = mean_directions(batch, cfg.eps_mass)
    meas_kap = kappas(batch)
    Lam_b = batch.Lambdas + cfg.eps_lift * jnp.eye(3, dtype=f)  # body precisions
    if getattr(cfg, "pose_point_to_plane", True):
        # Point-to-plane information for SURFELS (sources==1): project the
        # precision onto the surfel normal, Lambda_eff = (n^T Lambda n) n n^T.
        # A planar surfel carries NO in-plane alignment information; the
        # reference's full-Lambda WLS (visual_pose_evidence.py:712-714) sums
        # the spurious in-plane precision over hundreds of pairs and drags
        # the estimate toward stale map offsets (aperture problem). Camera
        # splats (sources==0) keep their full 3D precision.
        n_hat = meas_dir  # surfel normal = vMF mean direction
        lam_n = jnp.einsum("ni,nij,nj->n", n_hat, Lam_b, n_hat)
        # Information cap (1 cm measurement floor): surfel scatter along the
        # normal of a clean plane can reach sigma ~1 mm, so a SINGLE
        # mis-associated pair would carry ~1e6 * lever^2 of rotation
        # precision and yank the pose. No physical LiDAR+calibration chain
        # is better than ~1 cm, so clamp.
        lam_cap = 1.0 / (cfg.pose_sigma_floor_m**2)
        lam_n = jnp.minimum(lam_n, lam_cap)
        Lam_plane = lam_n[:, None, None] * n_hat[:, :, None] * n_hat[:, None, :]
        is_surfel = (batch.sources == 1)[:, None, None]
        Lam_b = jnp.where(is_surfel, Lam_plane + cfg.eps_lift * jnp.eye(3, dtype=f), Lam_b)
    # Camera/full-precision rows get the same cap via trace scaling.
    tr = jnp.trace(Lam_b, axis1=1, axis2=2)
    cap3 = 3.0 / (cfg.pose_sigma_floor_m**2)
    Lam_b = Lam_b * jnp.minimum(1.0, cap3 / (tr + cfg.eps_mass))[:, None, None]

    # Candidate attributes: dense take_along_axis over the CandidateSet when
    # the shortlist ran (no per-round gathers from the pool — the gathers,
    # not the math, dominated the GN round cost), else the original pool
    # gathers.
    if cands is not None:
        ci = assoc.cand_sl
        tk = lambda x: jnp.take_along_axis(
            x, ci.reshape(ci.shape + (1,) * (x.ndim - 2)), axis=1
        )
        cand_view_valid = tk(cands.valid)
        map_pos_g = tk(cands.pos)
        map_dir_g = tk(cands.dirs)
        map_kap_g = tk(cands.kap)
        map_w_g = tk(cands.weights)
        map_lfrac_g = None if cands.lidar_frac is None else tk(cands.lidar_frac)
    else:
        cand_view_valid = view.valid[assoc.cand_pool]
        map_pos_g = view.positions[assoc.cand_pool]
        map_dir_g = view.directions[assoc.cand_pool]
        map_kap_g = view.kappas[assoc.cand_pool]
        map_w_g = view.weights[assoc.cand_pool]
        map_lfrac_g = (None if view.lidar_frac is None
                       else view.lidar_frac[assoc.cand_pool])

    pi = assoc.responsibilities * (batch.valid[:, None] & cand_view_valid).astype(f)
    # Point-support scaling: OT responsibilities are transport PROBABILITIES
    # on uniform marginals a_i = 1/N_valid (total mass ~1), so summing
    # pi * Lambda treats an entire scan as ONE pseudo-measurement — the map
    # can never out-vote a single odometry factor (the reference inherits the
    # same weakness, visual_pose_evidence.py:712-714). Rescale each pair to
    # pi/a_i * w_i: pi/a_i in [0,1] is the row's matched fraction x
    # within-row responsibility, and w_i is the surfel's point support, which
    # recovers point-count-consistent ICP Laplace information.
    n_valid = jnp.sum(batch.valid.astype(f))
    pi = pi * n_valid * batch.weights[:, None]
    cam_w = getattr(cfg, "pose_camera_weight", 1.0)
    if cam_w != 1.0:
        pi = pi * jnp.where(batch.sources == 1, 1.0, cam_w)[:, None].astype(f)
    map_pos = map_pos_g  # (N, K, 3) world
    map_dir = map_dir_g
    map_kap = map_kap_g

    # Continuous Cauchy robustification of pair residuals (no gates): soft
    # OT leaves a few % of mass on wrong candidates whose meter-scale
    # residuals would otherwise pollute the WLS target. w = 1/(1+|r|^2/r0^2).
    r0_sq = cfg.pose_cauchy_r0_m**2
    meas_world_pre = meas_pos @ R0.T + t0[None, :]
    pair_r = map_pos - meas_world_pre[:, None, :]
    w_robust = 1.0 / (1.0 + jnp.sum(pair_r * pair_r, axis=-1) / r0_sq)
    # Normal-consistency weight (sign-invariant: surfel normals carry an
    # arbitrary eigenvector sign): a pair matching two DIFFERENT planes has
    # disagreeing normals; (n.n')^2 suppresses it before its (capped but
    # still large) point-to-plane precision enters the pose factor.
    meas_dir_w = meas_dir @ R0.T
    n_dot = jnp.einsum("ni,nki->nk", meas_dir_w, map_dir)
    # World-fixed-direction mask: surfel normals are properties of the
    # scene; camera splats' lobes are viewing rays (viewpoint-dependent),
    # so ray disagreement after the robot moved is parallax, not a wrong
    # match — and in the rotation scatter it reads as rotation error.
    if getattr(cfg, "pose_rot_scatter_surfels_only", True):
        dir_fixed = (batch.sources == 1)[:, None]
    else:
        dir_fixed = jnp.ones_like(n_dot, dtype=bool)
    w_normal = jnp.where((meas_kap[:, None] > 0) & dir_fixed, n_dot * n_dot, 1.0)
    w_robust = w_robust * w_normal
    # Map-maturity weighting (continuous): a freshly-seeded primitive (mass
    # ~novelty*w ~ 1e-2) carries almost no alignment authority; a repeatedly
    # fused one (mass >> 1) carries full weight. Prevents the sparse early
    # map from yanking the pose before it has converged.
    w_mature = map_w_g / (map_w_g + 1.0)
    pi = pi * w_robust * w_mature
    if getattr(cfg, "pose_modality_matched", True) and map_lfrac_g is not None:
        # Modality-matched pairs only: a camera corner matched to a
        # lidar-dominant slot compares a POINT against a plane-patch
        # CENTROID — the in-plane component of the residual is sampling
        # artifact, and camera rows carry full 3D precision that turns it
        # into a spurious pose pull (the aperture problem that
        # pose_point_to_plane already fixes for surfel rows). Camera rows
        # keep camera-dominant candidates (corner-to-corner, exact);
        # surfel rows keep lidar-dominant candidates. Map fusion is
        # unaffected (cross-modal depth PoE still happens in the atlas).
        lf = map_lfrac_g.astype(f)
        mode = getattr(cfg, "pose_modality_mode", "cam_to_lidar")
        if mode == "matched":
            w_mod = jnp.where((batch.sources == 1)[:, None], lf, 1.0 - lf)
        else:  # camera rows vote only against lidar-backed geometry
            w_mod = jnp.where((batch.sources == 1)[:, None], 1.0, lf)
        pi = pi * w_mod

    # ---- full 6x6 pose Laplace in the chart tangent ------------------------
    # r_tan(drho, dtheta) = R0^T (m_k - R0 Exp(dtheta)(p_i) - t0 - R0 V drho)
    #                     ~ r0 + A_i [drho; dtheta],  A_i = [-I | [p_i]x].
    # L6 = sum pi A^T Lam_b A,  h6_rel = -sum pi A^T Lam_b r0.
    # The [p]x lever-arm columns are what give scan-to-map alignment its
    # ROTATION authority (point-to-plane yaw information ~ lam * lever^2);
    # the reference's split translation-WLS + normal-scatter
    # (visual_pose_evidence.py:662-842) drops this coupling entirely, leaving
    # its map unable to correct heading against drifting odometry.
    pi_sum_k = jnp.sum(pi, axis=1)  # (N,)
    meas_world = meas_pos @ R0.T  # R0 p_i, (N, 3)
    r_world = map_pos - meas_world[:, None, :] - t0[None, None, :]  # (N, K, 3)
    r_tan = jnp.einsum("ji,nkj->nki", R0, r_world)  # R0^T r

    Px = se3.skew(meas_pos)  # (N, 3, 3) = [p_i]x
    # A^T Lam A blocks (A depends on i only):
    #   [ Lam        , -Lam Px ]
    #   [ -(Lam Px)^T, Px^T Lam Px ] with signs from A = [-I | Px]:
    LamPx = jnp.einsum("nij,njk->nik", Lam_b, Px)  # (N, 3, 3)
    PxLamPx = jnp.einsum("nji,njk->nik", Px, LamPx)  # Px^T Lam Px
    L6 = jnp.zeros((6, 6), dtype=f)
    L6 = L6.at[0:3, 0:3].set(jnp.einsum("n,nij->ij", pi_sum_k, Lam_b))
    L6 = L6.at[0:3, 3:6].set(-jnp.einsum("n,nij->ij", pi_sum_k, LamPx))
    L6 = L6.at[3:6, 0:3].set(L6[0:3, 3:6].T)
    L6 = L6.at[3:6, 3:6].set(jnp.einsum("n,nij->ij", pi_sum_k, PxLamPx))

    r_weighted = jnp.einsum("nk,nki->ni", pi, r_tan)  # (N, 3)
    Lr = jnp.einsum("nij,nj->ni", Lam_b, r_weighted)  # Lam r0 summed over k
    h6 = jnp.zeros((6,), dtype=f)
    h6 = h6.at[0:3].set(jnp.sum(Lr, axis=0))  # -(-I)^T Lam r0
    h6 = h6.at[3:6].set(-jnp.einsum("nji,nj->i", Px, Lr))  # -Px^T Lam r0
    trans_cost = jnp.einsum("nki,nij,nkj->", r_tan * pi[..., None], Lam_b, r_tan)

    L6 = linalg.sym(L6) + cfg.eps_lift * jnp.eye(6, dtype=f)

    # ---- rotation: Matrix-Fisher Laplace at the scatter mode ---------------
    kw = jnp.sqrt(meas_kap[:, None] * map_kap + 1e-12) * pi  # (N, K)
    kw = kw * dir_fixed.astype(f)  # viewing-ray rows carry no rotation vote
    if getattr(cfg, "pose_rot_scatter_surfels_only", True) and map_lfrac_g is not None:
        # ... and camera-dominant MAP slots (stale stored rays) don't either
        kw = kw * map_lfrac_g.astype(f)
    S = jnp.einsum("nk,nki,nj->ij", kw, map_dir, meas_dir)  # world x body scatter
    R_star, D, V = linalg.rotation_from_scatter(S)  # eigh-based, closed form
    # Laplace information of tr(S^T R) at R = R_star Exp(dtheta):
    # H = V (tr(D) I - D) V^T.
    H_diag = jnp.sum(D) - D
    L_rot = V @ (H_diag[:, None] * V.T)
    L_rot, pc = linalg.domain_projection_psd(linalg.sym(L_rot), cfg.eps_psd)
    L_rot = L_rot + cfg.eps_lift * jnp.eye(3, dtype=f)

    # right-perturbation residual toward the scatter mode
    rot_resid = se3.so3_log(R0.T @ R_star)
    h_rot = L_rot @ rot_resid

    rot_cost = jnp.sum(kw * (1.0 - jnp.einsum("ni,nki->nk", meas_dir @ R0.T, map_dir)))

    # ---- embed into 22D -----------------------------------------------------
    # Full coupled 6x6 alignment Laplace into the pose block, PLUS the
    # normal-alignment (scatter) rotation term — they are complementary:
    # lever arms constrain rotation about axes with range diversity, normal
    # agreement constrains it even for a single distant wall.
    # Fold the scatter rotation term into the 6x6 before flooring.
    L6 = L6.at[3:6, 3:6].add(L_rot)
    h6 = h6.at[3:6].add(h_rot)

    # Correlated-error information floor: summing per-pair information
    # treats pair residuals as independent, but the dominant per-scan
    # alignment errors (voxel-binning aliasing, range-density centroid
    # pull, deskew residue) are CORRELATED across the whole scan — the
    # aggregate claim of sigma ~0.5 mm is ~40x optimistic and lets the map
    # out-vote even perfect odometry, turning the map's own per-scan noise
    # into an unopposed random walk. Floor translation and rotation
    # SEPARATELY (heading deserves its own honest scale) via a congruence
    # scaling S L S (PSD-preserving); the factor's MAP target delta* is
    # held fixed so h is re-derived exactly, not approximately scaled.
    delta_star, _ = linalg.spd_solve_lifted(
        linalg.sym(L6) + cfg.eps_lift * jnp.eye(6, dtype=f), h6, cfg.eps_lift
    )
    eig_t, _ = linalg.eigh_3x3(linalg.sym(L6[0:3, 0:3]))
    eig_r, _ = linalg.eigh_3x3(linalg.sym(L6[3:6, 3:6]))
    cap_t = 1.0 / (cfg.pose_scan_sigma_floor_m**2)
    cap_r = 1.0 / (cfg.pose_scan_sigma_floor_rad**2)
    s_t = jnp.minimum(1.0, cap_t / jnp.maximum(eig_t[-1], cfg.eps_lift))
    s_r = jnp.minimum(1.0, cap_r / jnp.maximum(eig_r[-1], cfg.eps_lift))
    s_diag = jnp.concatenate([jnp.full(3, jnp.sqrt(s_t)), jnp.full(3, jnp.sqrt(s_r))])
    L6 = linalg.sym(s_diag[:, None] * L6 * s_diag[None, :])
    h6 = L6 @ delta_star

    L = cfg.eps_lift * jnp.eye(C.D_Z, dtype=f)
    h = jnp.zeros((C.D_Z,), dtype=f)
    L = L.at[C.IDX_POSE, C.IDX_POSE].add(L6)
    h = h.at[C.IDX_POSE].set(h6)

    ess = jnp.sum(assoc.row_masses)
    cert = make_cert(
        exact=False,
        triggers=TRIGGERS["linearization"] | TRIGGERS["ot_soft_correspondence"],
        frobenius_applied=1.0,
        ess_total=ess,
        support_frac=jnp.sum(batch.valid.astype(f)) / batch.valid.shape[0],
        nll_per_ess=(trans_cost + rot_cost) / (ess + cfg.eps_mass),
        lift_strength=cfg.eps_lift,
    )
    return L, h, cert
