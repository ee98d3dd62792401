"""Pipeline configuration — a frozen, hashable dataclass used as the STATIC
argument of the jitted scan step (reference PipelineConfig,
backend/pipeline.py:96-222, minus its mutable array fields: per-scan noise
matrices are data inputs here, not config).

All budgets mirror gcslam_tpu.constants; the config must MATCH the
compile-time constants or the runner refuses to start (reference
backend_node.py:548-586 budget fail-fast).
"""

from __future__ import annotations

import dataclasses
from gcslam_tpu import constants as C


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # Budgets (hard constants)
    k_hyp: int = C.K_HYP
    n_points_cap: int = C.N_POINTS_CAP
    n_feat: int = C.N_FEAT
    n_surfel: int = C.N_SURFEL
    max_imu_len: int = C.MAX_IMU_PREINT_LEN
    k_assoc: int = C.K_ASSOC
    k_sinkhorn: int = C.K_SINKHORN

    # Epsilons
    eps_psd: float = C.EPS_PSD
    eps_lift: float = C.EPS_LIFT
    eps_mass: float = C.EPS_MASS

    # Fusion / tempering
    alpha_min: float = C.ALPHA_MIN
    alpha_max: float = C.ALPHA_MAX
    kappa_scale: float = C.KAPPA_SCALE
    c0_cond: float = C.C0_COND
    power_beta_min: float = C.POWER_BETA_MIN
    power_beta_exc_c: float = C.POWER_BETA_EXC_C
    power_beta_z_c: float = C.POWER_BETA_Z_C
    c_dt: float = C.C_DT
    c_ex: float = C.C_EX
    c_frob: float = C.C_FROB

    # IMU
    imu_gravity_scale: float = 1.0
    deskew_rotation_only: bool = False
    # 'predict' (default): preintegration propagates the mean EKF-style and
    #   its noise inflates the covariance — the flagship filter.
    # 'evidence': reference parity — pure-diffusion predict + preintegration
    #   re-injected as additive evidence each scan
    #   (operators/imu_preintegration_factor.py:798-817).
    imu_mode: str = "predict"

    # Planar priors
    enable_planar_prior: bool = True
    planar_z_ref: float = C.PLANAR_Z_REF
    planar_z_sigma: float = C.PLANAR_Z_SIGMA
    planar_vz_sigma: float = C.PLANAR_VZ_SIGMA
    enable_odom_twist: bool = True
    # 'absolute' (default, reference parity): odom pose anchors the filter
    # to the odom frame — right when odom drift is small vs map authority.
    # 'relative': consecutive-odom delta factor (drift-immune but
    # unanchored; pair with loop closures / a mature map).
    odom_pose_mode: str = "absolute"

    # Map / atlas budgets
    with_map: bool = True
    atlas_max_tiles: int = C.ATLAS_MAX_TILES
    m_tile: int = C.M_TILE
    m_tile_view: int = C.M_TILE_VIEW
    h_tile: float = C.H_TILE
    n_active_tiles: int = C.N_ACTIVE_TILES
    n_stencil_tiles: int = C.N_STENCIL_TILES
    r_active_xy: int = C.R_ACTIVE_TILES_XY
    r_active_z: int = C.R_ACTIVE_TILES_Z
    r_stencil_xy: int = C.R_STENCIL_TILES_XY
    r_stencil_z: int = C.R_STENCIL_TILES_Z
    recency_decay_lambda: float = C.RECENCY_DECAY_LAMBDA
    recency_min_scale: float = C.RECENCY_MIN_SCALE
    k_insert_tile: int = C.K_INSERT_TILE
    k_merge_pairs_tile: int = C.K_MERGE_PAIRS_PER_TILE
    # Merge-reduce cadence: run the merge stage every K-th scan (1 = every
    # scan, reference behavior). Merge is the map update's heaviest stage
    # and its effect is maintenance. On the 50-scan production bench world
    # ATE rot grows with K, and K=2 stayed under the reference parity bar
    # (0.65 deg, BASELINE.md): merge's moment-matched averaging also acts as
    # map smoothing, not just compaction. Declared budgeting approximation;
    # set 1 for maximum-accuracy replays.
    merge_every: int = 2
    merge_threshold: float = C.PRIMITIVE_MERGE_THRESHOLD
    cull_weight_threshold: float = C.PRIMITIVE_CULL_WEIGHT_THRESHOLD
    forgetting_factor: float = C.PRIMITIVE_FORGETTING_FACTOR

    # OT association
    ot_epsilon: float = C.OT_EPSILON
    ot_tau_a: float = C.OT_TAU_A
    ot_tau_b: float = C.OT_TAU_B
    ot_cost_beta: float = C.OT_COST_BETA
    # Deviation from the reference default (primitive_association.py:223):
    # row-min subtraction erases the absolute cost scale, so every
    # measurement's best candidate gets responsibility even when it is
    # meters away — which both injects garbage pose evidence into a sparse
    # map and kills the novelty signal that drives insertion. Absolute costs
    # keep exp(-d^2/eps) as a ~0.5 m association radius.
    ot_subtract_row_min: bool = False
    # Distance shortlist: candidates per measurement pre-selected ONCE per
    # hypothesis by squared distance over the stencil pool; the full vMF
    # cost + Sinkhorn + top-k_assoc then run on (N, k_shortlist) instead of
    # (N, P) per GN round. 0 = score the whole pool every round (the
    # round-2 behavior). This is the array-program analog of the reference's
    # per-measurement hex-stencil candidate restriction
    # (primitive_association.py:307-365) — a certified budgeting
    # approximation (final top-k_assoc is by full cost WITHIN the
    # shortlist; the direction term can only reorder candidates within an
    # ot_cost_beta-wide cost band, so k_shortlist >> k_assoc keeps the
    # selection effectively exact).
    k_shortlist: int = 32
    # Extra metric reach (m) added to the stencil cutoff when shortlisting,
    # covering GN pose motion between the shortlist linearization point and
    # later rounds (trust-region caps steps at 2*sqrt(ot_epsilon) each).
    shortlist_margin_m: float = 1.0
    # Sinkhorn execution backend: "auto" runs the fused kernel
    # (ops/sinkhorn_pallas.py: the whole fixed-K iteration in ONE program
    # instead of a few tiny launches per iteration) on the GPU in float32,
    # and the XLA loop in float64 or on the CPU; "xla"/"pallas" force one
    # ("pallas" where it cannot run is an error, not an interpretation).
    sinkhorn_backend: str = "auto"
    # Share surfel extraction + the distance shortlist across the K_HYP
    # vmapped hypotheses (computed once from hypothesis 0's deskew at its
    # predicted pose). The hypotheses differ only through bias/pose estimates
    # whose effect on the constant-twist deskew is sub-voxel, while
    # extraction + the (N, P) shortlist selection dominate the map branch's
    # cost x4. Per-hypothesis GN rounds / association / pose evidence remain
    # independent. Declared approximation (hyp_shared_extraction trigger).
    # The reference extracts per hypothesis inside its sequential loop
    # (backend/pipeline.py:789 called from backend_node.py:2036).
    map_share_extraction: bool = True
    # Run the map-branch GN rounds ONCE per scan from hypothesis 0's
    # PREDICTED pose and give every hypothesis the same alignment factor
    # (linearized at the GN-refined pose; the per-hypothesis chart shift and
    # the diversified map_scale/beta trust profiles still differentiate what
    # each hypothesis DOES with it). The hypotheses' linearization points
    # differ by millimetres — well inside the coarse round's capture basin —
    # while the GN rounds (association + Sinkhorn + pose Laplace x rounds)
    # are the map branch's largest per-hypothesis cost. Requires
    # map_share_extraction. Declared approximation (hyp_shared_extraction).
    map_gn_shared: bool = True

    # Surfel extraction
    surfel_voxel_size_m: float = 0.1
    surfel_min_points_per_voxel: int = 3
    # Point-to-plane information for surfel pose evidence (see
    # ops/evidence_pose.py; the reference uses full-matrix WLS).
    pose_point_to_plane: bool = True
    # Ablation/tuning: global scale on the map (primitive-alignment) pose
    # evidence. 0 disables it (map maintenance still runs).
    map_evidence_scale: float = 1.0
    # Scan-to-map Gauss-Newton rounds (re-associate + re-linearize). 1 =
    # single-shot (reference behavior); 2 removes most of the soft-OT
    # shrinkage/linearization bias at ~2x the map-branch cost.
    map_icp_iters: int = 2
    # Coarse-to-fine anneal: round r uses ot_epsilon * factor^(R-1-r) (and
    # cauchy_r0 * sqrt of same), so early rounds have a wide capture basin
    # and the final factor is tight/unbiased.
    map_icp_coarse_factor: float = 8.0
    # Per-pair information floor/robustness for the pose factor.
    pose_sigma_floor_m: float = 0.01
    pose_cauchy_r0_m: float = 0.05
    # Whole-scan information caps (correlated-error model): the factor never
    # claims alignment better than these sigmas (translation / rotation).
    pose_scan_sigma_floor_m: float = 0.02
    pose_scan_sigma_floor_rad: float = 0.002

    # Camera
    with_camera: bool = False
    # Keep only world-fixed directions (surfel normals, sources==1) in the
    # Matrix-Fisher rotation scatter and the normal-consistency weight.
    # Camera splats' vMF lobe is the VIEWING RAY — viewpoint-dependent, so
    # matching the map's stored ray against the current ray reads
    # translation parallax as body rotation (measured as a ~30x ATE-rot
    # blowup with the camera on). Camera splats still contribute rotation
    # information through the lever-arm coupling of the 6x6 pose Laplace,
    # which models the translation-rotation geometry exactly.
    pose_rot_scatter_surfels_only: bool = True
    # Scale on camera-splat rows' responsibilities in the pose factor
    # (surfel rows unaffected; map maintenance/rendering unaffected).
    # Harris corners sit preferentially on depth discontinuities, where the
    # local plane fit mixes foreground/background depths — a biased, hard-
    # to-model error that full-3D-precision rows amplify through the
    # lever-arm coupling. 0 = camera is mapped + rendered but never votes
    # on the pose.
    pose_camera_weight: float = 1.0
    # Modality weighting of pose-factor pairs (map fusion stays
    # cross-modal). Measured on the synthetic camera world (round 5):
    #   - "cam_to_lidar" (default): camera rows vote only against
    #     lidar-dominant slots. Camera-to-camera-splat matching is the
    #     measured poison — repeated texture corners alias under OT at
    #     0.5 m spacing, and fused splat positions carry absorbed pose
    #     error, a self-reinforcing loop (ATE rot 0.95 deg -> 0.39 = the
    #     no-camera control).
    #   - "matched": modality-consistent pairs only (cam<->cam,
    #     lidar<->lidar). Measured 8x WORSE (7.8 deg) — kept as the
    #     documented negative ablation.
    pose_modality_matched: bool = True
    pose_modality_mode: str = "cam_to_lidar"

    # Hypothesis diversification: run K_HYP distinct evidence-trust profiles
    # (constants.HYP_BETA_SCALE / HYP_MAP_EVIDENCE_SCALE) with per-scan
    # weight updates from evidence fit. False = reference parity (identical
    # hypotheses, static weights).
    hyp_diversify: bool = True

    def validate(self) -> None:
        """Param-registry fail-fast (the reference's PARAM_SPECS + budget
        check, backend_node.py:121-245,548-586): hard budgets must match the
        compiled constants, every numeric field must be in its declared
        range, and enums must be known values. No silent defaults, no
        clamping — a bad config refuses to start."""
        hard = {
            "k_hyp": C.K_HYP,
            "n_points_cap": C.N_POINTS_CAP,
            "max_imu_len": C.MAX_IMU_PREINT_LEN,
            "k_assoc": C.K_ASSOC,
            "k_sinkhorn": C.K_SINKHORN,
        }
        for name, expected in hard.items():
            got = getattr(self, name)
            if got != expected:
                raise ValueError(
                    f"PipelineConfig.{name}={got} does not match compiled constant {expected}; "
                    "budgets are compile-time constants (no silent overrides)."
                )
        for name, lo, hi in PARAM_RANGES:
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(
                    f"PipelineConfig.{name}={v} outside declared range [{lo}, {hi}]"
                )
        for name, allowed in PARAM_ENUMS:
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(f"PipelineConfig.{name}={v!r} not in {allowed}")
        if self.m_tile_view > self.m_tile:
            raise ValueError("m_tile_view must be <= m_tile")
        if 0 < self.k_shortlist < self.k_assoc:
            raise ValueError("k_shortlist must be 0 (off) or >= k_assoc")
        if self.map_gn_shared and not self.map_share_extraction:
            raise ValueError("map_gn_shared requires map_share_extraction")


# Declared ranges for every tunable numeric (name, min, max) — the registry
# the reference keeps as PARAM_SPECS.
PARAM_RANGES = [
    ("eps_psd", 0.0, 1.0),
    ("eps_lift", 0.0, 1.0),
    ("eps_mass", 0.0, 1.0),
    ("alpha_min", 0.0, 1.0),
    ("alpha_max", 0.0, 1.0),
    ("kappa_scale", 0.0, 1e6),
    ("power_beta_min", 0.0, 1.0),
    ("imu_gravity_scale", 0.0, 2.0),
    ("planar_z_sigma", 1e-6, 1e3),
    ("planar_vz_sigma", 1e-6, 1e3),
    ("atlas_max_tiles", 1, 65536),
    ("m_tile", 1, 65536),
    ("m_tile_view", 1, 65536),
    ("h_tile", 1e-3, 1e3),
    ("recency_decay_lambda", 0.0, 10.0),
    ("recency_min_scale", 0.0, 1.0),
    ("k_insert_tile", 1, 4096),
    ("merge_threshold", 0.0, 1e6),
    ("merge_every", 1, 64),
    ("cull_weight_threshold", 0.0, 1e6),
    ("forgetting_factor", 0.0, 1.0),
    ("ot_epsilon", 1e-6, 1e3),
    ("ot_tau_a", 0.0, 1e6),
    ("ot_tau_b", 0.0, 1e6),
    ("ot_cost_beta", 0.0, 1e6),
    ("k_shortlist", 0, 65536),
    ("shortlist_margin_m", 0.0, 100.0),
    ("surfel_voxel_size_m", 1e-3, 10.0),
    ("surfel_min_points_per_voxel", 1, 1024),
    ("map_evidence_scale", 0.0, 1e3),
    ("map_icp_iters", 1, 8),
    ("map_icp_coarse_factor", 1.0, 64.0),
    ("pose_sigma_floor_m", 1e-6, 1.0),
    ("pose_cauchy_r0_m", 1e-4, 10.0),
    ("pose_scan_sigma_floor_m", 1e-6, 1.0),
    ("pose_scan_sigma_floor_rad", 1e-6, 1.0),
    ("pose_camera_weight", 0.0, 1e3),
]

PARAM_ENUMS = [
    ("imu_mode", ("predict", "evidence")),
    ("odom_pose_mode", ("absolute", "relative")),
    ("sinkhorn_backend", ("auto", "xla", "pallas")),  # sinkhorn_pallas.BACKENDS
    ("pose_modality_mode", ("cam_to_lidar", "matched")),
]


def config_from_file(path: str, **overrides) -> "PipelineConfig":
    """Load a PipelineConfig from YAML or JSON — the single-config contract
    of the reference's config/gc_unified.yaml (SURVEY.md 2.8). Unknown keys
    are a hard error (no silent defaults), kwargs override file values, and
    the result is validate()d before it is returned."""
    import dataclasses
    import json

    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        data = yaml.safe_load(text)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a mapping at top level, got {type(data)}")
    # Reserved sections consumed by their own loaders: `frontend:` ->
    # rosbag.bag_config_from_file (topics/extrinsics/camera/alignment),
    # `eval:` -> eval.run (gt path, bag path, alignment choice).
    data.pop("frontend", None)
    data.pop("eval", None)
    known = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(f"{path}: unknown PipelineConfig keys: {unknown}")
    data.update(overrides)
    cfg = PipelineConfig(**data)
    cfg.validate()
    return cfg
