"""THE scan step — the whole 14-step per-scan pipeline as one jitted,
fixed-shape function.

    scan_step(state, batch, config) -> (state', StepOutput)

Everything the reference spreads over a ROS node + Python operator dispatch
(backend/pipeline.py:316-1591 + backend_node.py:1651-2210) compiles here into
a single XLA program: hypotheses are vmapped, the map lives in the carry as a
device-resident atlas, IW states update in-graph, and the certificate system
is a numeric pytree. A full run is `jax.lax.scan(scan_step, state0, batches)`
or a host loop calling the jitted step for streaming.

Canonical per-scan order (docs/PIPELINE_ORDER_AND_EVIDENCE.md; pipeline.py:342-361):
  1 PointBudgetResample (done by the frontend: inputs arrive budgeted)
  2 PredictDiffusion          3 soft IMU windows     4 preintegration x2
  5 DeskewConstantTwist       6 IMU+odom evidence -> z_lin
  7 surfels + OT association  8 primitive-alignment pose evidence
  9 power tempering          10 excitation prior scaling
 11 fusion alpha             12 InfoFusionAdditive
 13 FrobeniusRecompose       14 IW suffstats
 15 map update (fuse/insert/cull/forget/merge)      16 AnchorDriftUpdate
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from gcslam_tpu.utils.xla import jax, jnp, BELIEF_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.models.belief import Belief, mean_increment, to_moments, world_pose
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models.scan_io import ScanBatch
from gcslam_tpu.ops import certs as CT
from gcslam_tpu.ops import evidence_imu, evidence_odom, fusion, iw, linalg, recompose, se3
from gcslam_tpu.ops.hypothesis import hypothesis_barycenter
from gcslam_tpu.ops.preintegration import (
    imu_integration_time,
    imu_mean_sample_period,
    preintegrate,
)
from gcslam_tpu.ops.windows import smooth_window_weights


class StepState(NamedTuple):
    """The carry: complete device-resident filter state (a pytree —
    checkpointing the run is a single orbax/np.savez of this tuple)."""

    beliefs: Belief  # stacked over K_HYP
    hyp_weights: jnp.ndarray  # (K_HYP,)
    process_iw: iw.ProcessNoiseIW
    meas_iw: iw.MeasurementNoiseIW
    atlas: object  # AtlasState | None (static presence via config.with_map)
    scan_count: jnp.ndarray  # () int32


class ScanTape(NamedTuple):
    """Per-scan diagnostics (numeric MinimalScanTape,
    reference backend/diagnostics.py:19-160). Stacks under lax.scan."""

    timestamp: jnp.ndarray
    dt_sec: jnp.ndarray
    fusion_alpha: jnp.ndarray
    power_beta: jnp.ndarray
    cond_pose6: jnp.ndarray
    eigmin_pose6: jnp.ndarray
    total_trigger_magnitude: jnp.ndarray
    cert_exact: jnp.ndarray
    cert_frobenius_applied: jnp.ndarray
    cert_n_triggers: jnp.ndarray
    cert_triggers: jnp.ndarray  # uint64 bitmask
    support_ess_total: jnp.ndarray
    support_frac: jnp.ndarray
    mismatch_nll_per_ess: jnp.ndarray
    mismatch_directional_score: jnp.ndarray
    excitation_dt_effect: jnp.ndarray
    excitation_extrinsic_effect: jnp.ndarray
    influence_psd_projection_delta: jnp.ndarray
    influence_anchor_drift_rho: jnp.ndarray
    influence_dt_scale: jnp.ndarray
    influence_extrinsic_scale: jnp.ndarray
    overconfidence_dt_asymmetry: jnp.ndarray
    overconfidence_z_to_xy_ratio: jnp.ndarray
    overconfidence_ess_to_excitation: jnp.ndarray
    hyp_spread: jnp.ndarray
    # ExpectedEffect: predicted vs realized per-scan effects (reference
    # certificates.py:488 — the audit compares these columns)
    ee_pose_shift_pred: jnp.ndarray
    ee_pose_shift_real: jnp.ndarray
    ee_info_gain_pred: jnp.ndarray
    ee_info_gain_real: jnp.ndarray
    # map counters (zero when with_map=False)
    map_fused_mass: jnp.ndarray
    map_insert_mass: jnp.ndarray
    map_evicted_mass: jnp.ndarray
    map_n_culled: jnp.ndarray
    map_n_merged: jnp.ndarray
    map_valid_total: jnp.ndarray
    ot_transport_mass: jnp.ndarray
    ot_marginal_defect_a: jnp.ndarray
    # per-insertion event payloads (reference pipeline.py:1393-1410): fixed
    # (S*K_INSERT,) arrays per scan, id=-1 marks unused rows; (0,) when no map
    map_ins_ids: jnp.ndarray  # int32 primitive ids
    map_ins_tiles: jnp.ndarray  # int64 tile ids
    map_ins_mu: jnp.ndarray  # (., 3) world positions
    map_ins_w: jnp.ndarray  # weights
    # scan-IO stream health (numeric ScanIOCert, reference
    # certificates.py:274-296: per-stream buffer windows/coverage/drops)
    io_n_points_valid: jnp.ndarray
    io_n_imu_valid: jnp.ndarray
    io_imu_coverage: jnp.ndarray  # dt_int / dt_sec in [0,1]
    io_n_cam_valid: jnp.ndarray
    io_loop_weight: jnp.ndarray
    io_point_weight_sum: jnp.ndarray


class StepOutput(NamedTuple):
    pose: jnp.ndarray  # (6,) combined world pose [trans, rotvec]
    stamp: jnp.ndarray  # ()
    tape: ScanTape


# --- packed tape transport for lax.scan (op-count campaign, round 5) -------
# Stacking ~44 individual 0-d tape outputs through lax.scan costs one
# dynamic-update-slice + carry-tuple entry EACH per scan (the optimized HLO
# showed 42x f32[50] DUS per iteration, tools/hlo_census). The scalar fields ride
# as ONE (F,) vector instead; timestamp stays separate (TIME_DTYPE f64 must
# not round through the f32 belief dtype), as do the uint64 trigger mask and
# the per-insertion event arrays.
_TAPE_NONSCALAR = ("timestamp", "cert_triggers", "map_ins_ids",
                   "map_ins_tiles", "map_ins_mu", "map_ins_w")
_TAPE_PACKED_FIELDS = tuple(
    f for f in ScanTape._fields if f not in _TAPE_NONSCALAR)


class PackedStepOutput(NamedTuple):
    pose: jnp.ndarray  # (6,)
    stamp: jnp.ndarray  # ()
    tape_vec: jnp.ndarray  # (F,) scalar tape fields, BELIEF_DTYPE
    tape_timestamp: jnp.ndarray  # () TIME_DTYPE
    tape_triggers: jnp.ndarray  # () uint64
    ins_ids: jnp.ndarray
    ins_tiles: jnp.ndarray
    ins_mu: jnp.ndarray
    ins_w: jnp.ndarray


def pack_output(out: StepOutput) -> PackedStepOutput:
    t = out.tape
    vec = jnp.stack([getattr(t, f).astype(BELIEF_DTYPE)
                     for f in _TAPE_PACKED_FIELDS])
    return PackedStepOutput(
        pose=out.pose, stamp=out.stamp, tape_vec=vec,
        tape_timestamp=t.timestamp, tape_triggers=t.cert_triggers,
        ins_ids=t.map_ins_ids, ins_tiles=t.map_ins_tiles,
        ins_mu=t.map_ins_mu, ins_w=t.map_ins_w,
    )


def unpack_outputs(p: PackedStepOutput) -> StepOutput:
    """Inverse of pack_output; works on lax.scan-stacked outputs too (the
    field axis is the LAST axis of tape_vec)."""
    cols = {f: p.tape_vec[..., i] for i, f in enumerate(_TAPE_PACKED_FIELDS)}
    tape = ScanTape(
        timestamp=p.tape_timestamp, cert_triggers=p.tape_triggers,
        map_ins_ids=p.ins_ids, map_ins_tiles=p.ins_tiles,
        map_ins_mu=p.ins_mu, map_ins_w=p.ins_w, **cols,
    )
    return StepOutput(pose=p.pose, stamp=p.stamp, tape=tape)


class HypOutputs(NamedTuple):
    belief: Belief
    dPsi_proc: jnp.ndarray
    dnu_proc: jnp.ndarray
    dPsi_meas: jnp.ndarray
    dnu_meas: jnp.ndarray
    cert_agg: CT.Cert
    total_trigger_mag: jnp.ndarray
    cond_pose6: jnp.ndarray
    eigmin_pose6: jnp.ndarray
    alpha: jnp.ndarray
    beta: jnp.ndarray
    sent_dt_asym: jnp.ndarray
    sent_z_ratio: jnp.ndarray
    ess_to_exc: jnp.ndarray
    s_dt: jnp.ndarray
    s_ex: jnp.ndarray
    # ExpectedEffect channel (reference certificates.py:488)
    ee_pose_shift_pred: jnp.ndarray
    ee_pose_shift_real: jnp.ndarray
    ee_info_gain_pred: jnp.ndarray
    ee_info_gain_real: jnp.ndarray
    # handles for the shared (hypothesis-0) map update
    z_t_pose: jnp.ndarray  # (6,) post-recompose world pose
    map_extras: object  # atlas.MapExtras | None


def _hypothesis_step(
    belief_prev: Belief,
    batch: ScanBatch,
    Q: jnp.ndarray,
    Sigma_g: jnp.ndarray,
    Sigma_a: jnp.ndarray,
    map_evidence_fn,
    config: PipelineConfig,
    inputs_finite: jnp.ndarray = None,
    beta_scale: jnp.ndarray = None,
    map_scale: jnp.ndarray = None,
) -> HypOutputs:
    """Steps 2-14 for one hypothesis (vmapped by the caller).

    `map_evidence_fn(deskewed_points, deskewed_weights, point_stamps,
    z_lin_pose, belief_pred) -> (L_lidar, h_lidar, certs_list)` supplies the
    map branch (steps 7-8); the no-map config passes a zero-evidence fn.
    """
    cfg = config
    all_certs = []
    imu_predict = cfg.imu_mode == "predict"

    # --- Step 3 (hoisted): soft IMU membership windows -------------------
    # sigma_warp from the previous belief's dt marginal (the reference reads
    # the predicted one, pipeline.py:436-438; under diffusion-predict the dt
    # marginal is unchanged to within Q_dt*dt ~ 1e-7).
    _, Sigma_prev_full, _ = to_moments(belief_prev, cfg.eps_lift)
    dt_std = jnp.sqrt(jnp.abs(Sigma_prev_full[C.IDX_DT, C.IDX_DT]))
    # Physical cap: a time-offset uncertainty beyond a quarter scan interval
    # makes the soft membership window flatter than the data can ever
    # support — it under-weights EVERY in-window sample uniformly (an
    # unbounded sigma_warp is how the dt-variance runaway turned into a 30%
    # gyro under-integration; see ops/iw.process_iw_suffstats).
    warp_cap = jnp.maximum(0.25 * batch.dt_sec, 0.01)
    sigma_warp = jnp.clip(dt_std, 0.01, warp_cap)
    w_imu_scan = smooth_window_weights(
        batch.imu_stamps, batch.scan_start_time, batch.scan_end_time, sigma_warp
    )
    w_imu_int = smooth_window_weights(
        batch.imu_stamps, batch.t_last_scan, batch.t_scan, sigma_warp
    )

    mu_prev = mean_increment(belief_prev, cfg.eps_lift)
    gyro_bias = mu_prev[C.IDX_BG]
    accel_bias = mu_prev[C.IDX_BA]
    pose0 = world_pose(belief_prev, cfg.eps_lift)
    rotvec0 = pose0[3:6]
    gravity_W = jnp.asarray(C.GRAVITY_W, dtype=BELIEF_DTYPE) * cfg.imu_gravity_scale

    # --- Step 4 (hoisted): preintegration (parallel associative scan) x2 --
    # target_dt normalizes the soft-window effective time to actual IMU
    # coverage (+ half a sample period per edge), capped at the window length
    # (see preintegration.preintegrate); dropouts keep their true coverage.
    dt_int = imu_integration_time(batch.imu_stamps, batch.t_last_scan, batch.t_scan)
    dt_imu = imu_mean_sample_period(batch.imu_stamps)
    dt_cov_scan = imu_integration_time(
        batch.imu_stamps, batch.scan_start_time, batch.scan_end_time
    )
    target_scan = jnp.minimum(
        jnp.maximum(batch.scan_end_time - batch.scan_start_time, 0.0), dt_cov_scan + dt_imu
    )
    target_int = jnp.minimum(
        jnp.maximum(batch.t_scan - batch.t_last_scan, 0.0), dt_int + dt_imu
    )
    # Both windows (scan-coverage and scan-to-scan) share every input except
    # the membership weights / target time — one vmapped associative scan
    # computes them together (halves the log-depth chain count; same math).
    pre2 = jax.vmap(
        preintegrate, in_axes=(None, None, None, 0, None, None, None, None, 0)
    )(
        batch.imu_stamps, batch.imu_gyro, batch.imu_accel,
        jnp.stack([w_imu_scan, w_imu_int]),
        rotvec0, gyro_bias, accel_bias, gravity_W,
        jnp.stack([target_scan, target_int]),
    )
    pre_scan = jax.tree_util.tree_map(lambda x: x[0], pre2)
    pre_int = jax.tree_util.tree_map(lambda x: x[1], pre2)
    xi_body = se3.se3_log(pre_scan.delta_pose)
    trans_scale = 0.0 if cfg.deskew_rotation_only else 1.0
    xi_body = xi_body.at[:3].multiply(trans_scale)

    # --- Step 2: prediction ------------------------------------------------
    from gcslam_tpu.ops.predict import predict_diffusion, predict_imu

    if imu_predict:
        # Rate fusion in the PREDICTION: the wheel yaw-rate is a measurement
        # of the same increment the gyro integrates, so it belongs in the
        # prediction (inverse-variance fusion of the rotvec-z increment),
        # NOT in the evidence stack. Injecting increment measurements as
        # absolute-slot factors (the reference's yawrate/kinematic path,
        # odom_twist_evidence.py:157-397) adds ~1/prior_var of absolute
        # precision every scan, so the claimed yaw variance saturates near
        # the per-scan level while true dead-reckoning error grows — the
        # filter becomes UNFALSIFIABLY overconfident and no map/loop/odom
        # correction can move it. Increment fusion keeps the increments
        # tight and lets absolute variance grow honestly.
        delta_pose_f = pre_int.delta_pose
        if cfg.enable_odom_twist:
            var_g = Sigma_g[2, 2] * jnp.maximum(dt_int, 1e-6)
            sigma_wz_sq = jnp.maximum(batch.odom_twist_cov[5, 5], 1e-12)
            var_o = sigma_wz_sq * jnp.maximum(dt_int, 1e-6) ** 2 + C.EPS_MASS * 1e-3
            w_g = var_o / (var_g + var_o)
            dz_odom = batch.odom_twist[5] * dt_int
            dz_f = w_g * pre_int.delta_pose[5] + (1.0 - w_g) * dz_odom
            delta_pose_f = pre_int.delta_pose.at[5].set(dz_f)
        belief_pred, pred_cert = predict_imu(
            belief_prev, Q, batch.dt_sec, delta_pose_f, pre_int.delta_v,
            dt_int, Sigma_g, Sigma_a, cfg.eps_psd, cfg.eps_lift,
        )
    else:
        belief_pred, pred_cert = predict_diffusion(
            belief_prev, Q, batch.dt_sec, cfg.eps_psd, cfg.eps_lift
        )
    all_certs.append(pred_cert)
    _, Sigma_pred, _ = to_moments(belief_pred, cfg.eps_lift)
    mu_inc = mean_increment(belief_pred, cfg.eps_lift)

    # IMU measurement-noise suffstats (commutative; applied once per scan)
    imu_valid = (batch.imu_stamps > 0.0).astype(BELIEF_DTYPE)
    w_int_valid = w_imu_int * imu_valid
    w_norm = w_int_valid / (jnp.sum(w_int_valid) + cfg.eps_mass)
    omega_avg = jnp.einsum("m,mi->i", w_norm, batch.imu_gyro - gyro_bias[None, :])
    dPsi_g, dnu_g = iw.gyro_meas_suffstats(
        batch.imu_gyro, w_int_valid, gyro_bias, omega_avg, dt_imu, cfg.eps_mass
    )
    dPsi_a, dnu_a = iw.accel_meas_suffstats(
        rotvec0, batch.imu_accel, w_int_valid, accel_bias, gravity_W, dt_imu, cfg.eps_mass
    )
    dPsi_meas = dPsi_g + dPsi_a
    dnu_meas = dnu_g + dnu_a  # LiDAR block added after the map branch below

    # --- Step 5: deskew (constant twist) --------------------------------
    from gcslam_tpu.ops.deskew import deskew_constant_twist

    deskewed_points, deskewed_weights, deskew_cert = deskew_constant_twist(
        batch.points, batch.point_stamps, batch.point_weights,
        batch.scan_start_time, batch.scan_end_time, xi_body, pre_scan.ess,
    )
    all_certs.append(deskew_cert)

    # --- Step 6: IMU + odom evidence branch -> z_lin --------------------
    pose_pred = world_pose(belief_pred, cfg.eps_lift)

    if cfg.odom_pose_mode == "relative":
        # Relative-odometry factor: target = pose0 o odom_rel; covariance
        # carries the head marginal (pose0 is the filter's own uncertain
        # previous pose) + the odom delta noise.
        odom_target = se3.se3_compose(pose0, batch.odom_rel_pose)
        rel_cov = batch.odom_rel_cov
        rel_cov = rel_cov.at[0:3, 0:3].add(Sigma_pred[C.IDX_TRANS, C.IDX_TRANS])
        rel_cov = rel_cov.at[3:6, 3:6].add(Sigma_pred[C.IDX_ROT, C.IDX_ROT])
        L_odom, h_odom, odom_cert = evidence_odom.odom_quadratic_evidence(
            pose_pred, odom_target, rel_cov, cfg.eps_psd, cfg.eps_lift
        )
    else:
        L_odom, h_odom, odom_cert = evidence_odom.odom_quadratic_evidence(
            pose_pred, batch.odom_pose, batch.odom_cov, cfg.eps_psd, cfg.eps_lift
        )
    all_certs.append(odom_cert)

    # Loop-closure late evidence (LoopFactor contract): same Gaussian SE(3)
    # form, continuously weighted by loop_weight (0 when absent); the
    # budgeted recomposition that absorbs it is the ordinary Frobenius
    # recompose of step 13 — no iterative optimization (spec 6.12).
    L_loop, h_loop, _loop_cert = evidence_odom.odom_quadratic_evidence(
        pose_pred, batch.loop_pose, batch.loop_cov, cfg.eps_psd, cfg.eps_lift
    )
    L_loop = batch.loop_weight * L_loop
    h_loop = batch.loop_weight * h_loop

    grav, grav_cert = evidence_imu.imu_gravity_evidence_time_resolved(
        pose_pred[3:6], batch.imu_accel, batch.imu_gyro, w_imu_int,
        accel_bias, gravity_W, dt_imu, cfg.eps_psd, cfg.eps_mass,
    )
    all_certs.append(grav_cert)
    imu_dep_scale, dep_cert = evidence_imu.imu_dependence_inflation(
        grav.transport_sigma, cfg.eps_mass
    )
    all_certs.append(dep_cert)

    Sigma_prev_pos = Sigma_pred[C.IDX_TRANS, C.IDX_TRANS]
    Sigma_prev_rot = Sigma_pred[C.IDX_ROT, C.IDX_ROT]
    Sigma_prev_vel = Sigma_pred[C.IDX_VEL, C.IDX_VEL]
    if imu_predict:
        # Preintegration was consumed by predict_imu; re-adding it as
        # evidence would double count. Zero factors keep the cert schema.
        zero_L = jnp.zeros((C.D_Z, C.D_Z), dtype=BELIEF_DTYPE)
        zero_h = jnp.zeros((C.D_Z,), dtype=BELIEF_DTYPE)
        L_gyro, h_gyro = zero_L, zero_h
        preint_fac = evidence_imu.PreintFactor(
            L=zero_L, h=zero_h, r_vel=jnp.zeros(3, dtype=BELIEF_DTYPE),
            r_pos=jnp.zeros(3, dtype=BELIEF_DTYPE),
        )
        gyro_cert = CT.make_cert(exact=True)
    else:
        L_gyro, h_gyro, _r_rot, gyro_cert = evidence_imu.imu_gyro_rotation_evidence(
            rotvec0, pose_pred[3:6], pre_int.delta_pose[3:6], Sigma_g, dt_int,
            cfg.eps_psd, cfg.eps_lift,
        )
        all_certs.append(gyro_cert)
        preint_fac, preint_cert = evidence_imu.imu_preintegration_factor(
            pose0[0:3], rotvec0, mu_prev[C.IDX_VEL], pose_pred[0:3], mu_inc[C.IDX_VEL],
            pose_pred[3:6], pre_int.delta_v, pre_int.delta_p, Sigma_a, dt_int,
            Sigma_prev_pos, Sigma_prev_vel, cfg.eps_psd, cfg.eps_lift,
        )
        all_certs.append(preint_cert)

    if cfg.enable_planar_prior:
        L_planar, h_planar, planar_cert = evidence_odom.planar_z_prior(
            pose_pred, cfg.planar_z_ref, cfg.planar_z_sigma
        )
        all_certs.append(planar_cert)
        L_vz, h_vz, vz_cert = evidence_odom.velocity_z_prior(
            mu_inc[C.IDX_VEL][2], cfg.planar_vz_sigma
        )
        all_certs.append(vz_cert)
    else:
        L_planar = jnp.zeros((C.D_Z, C.D_Z), dtype=BELIEF_DTYPE)
        h_planar = jnp.zeros((C.D_Z,), dtype=BELIEF_DTYPE)
        L_vz, h_vz = L_planar, h_planar

    R_world_body = se3.so3_exp(pose_pred[3:6])
    L_vel, h_vel, vel_cert, _ = evidence_odom.odom_velocity_evidence(
        mu_inc[C.IDX_VEL], R_world_body, batch.odom_twist[0:3],
        batch.odom_twist_cov[0:3, 0:3], cfg.eps_psd, cfg.eps_lift,
    )
    all_certs.append(vel_cert)
    sigma_wz = jnp.sqrt(jnp.maximum(batch.odom_twist_cov[5, 5], 1e-12))
    L_wz, h_wz, wz_cert = evidence_odom.odom_yawrate_evidence(
        omega_avg[2], batch.odom_twist[5], sigma_wz, batch.dt_sec,
        Sigma_prev_rot[2, 2],
    )
    all_certs.append(wz_cert)
    kin, kin_cert = evidence_odom.pose_twist_kinematic_consistency(
        pose0, pose_pred, batch.odom_twist[0:3], batch.odom_twist[3:6], batch.dt_sec,
        batch.odom_twist_cov[0:3, 0:3], batch.odom_twist_cov[3:6, 3:6],
        Sigma_prev_pos, Sigma_prev_rot, cfg.eps_psd, cfg.eps_lift,
    )
    all_certs.append(kin_cert)
    odom_dep_scale, odom_dep_cert = evidence_odom.odom_dependence_inflation(
        kin.r_trans, kin.r_rot, cfg.eps_mass
    )
    all_certs.append(odom_dep_cert)

    twist_on = 1.0 if cfg.enable_odom_twist else 0.0
    # In predict mode the yaw-rate measurement is fused into the prediction
    # increment (see step 2) and the kinematic-consistency constraint is
    # already embodied by the prediction itself — re-adding them as factors
    # double counts the head marginal every scan and saturates the claimed
    # pose variance (see the rate-fusion note above). They remain active in
    # 'evidence' mode (reference parity), and kin is still computed for the
    # odom dependence inflation certificate.
    rel_on = 0.0 if imu_predict else twist_on
    # Every factor above was linearized at the predicted mean mu_inc and
    # returns h = L @ r (a Newton step). In chart coordinates the factor's
    # information vector must be h = L @ (mu_inc + r): the reference omits
    # the L @ mu term everywhere (e.g. odom_evidence.py:57-63,
    # odom_twist_evidence.py:116-117), which is only consistent when the
    # chart increment is ~0 — its recompose keeps the POSE slice near zero,
    # but the velocity/bias slices are NOT re-zeroed, so its velocity
    # factors actively drag the velocity state toward (v_odom - v_pred)
    # instead of v_odom. We add the L @ mu_inc shift once on the summed
    # branch below (all factors share the same linearization point).
    L_imu_odom = (
        odom_dep_scale * L_odom
        + L_loop
        + imu_dep_scale * (grav.L + L_gyro)
        + preint_fac.L
        + L_planar
        + L_vz
        + twist_on * odom_dep_scale * L_vel
        + rel_on * odom_dep_scale * L_wz
        + rel_on * kin.L
    )
    h_imu_odom = (
        odom_dep_scale * h_odom
        + h_loop
        + imu_dep_scale * (grav.h + h_gyro)
        + preint_fac.h
        + h_planar
        + h_vz
        + twist_on * odom_dep_scale * h_vel
        + rel_on * odom_dep_scale * h_wz
        + rel_on * kin.h
    )
    h_imu_odom = h_imu_odom + L_imu_odom @ mu_inc

    # IMU+odom-informed linearization point (pipeline.py:751-755)
    L_fused_psd, _ = linalg.domain_projection_psd(belief_pred.L + L_imu_odom, cfg.eps_psd)
    z_lin_22d, _ = linalg.spd_solve_lifted(L_fused_psd, belief_pred.h + h_imu_odom, cfg.eps_lift)
    z_lin_chart = z_lin_22d[C.IDX_POSE]
    # Map evidence linearizes around the WORLD pose at the chart increment.
    z_lin_pose_world = se3.se3_compose(belief_pred.X_anchor, se3.se3_exp(z_lin_chart))

    # --- Steps 7-8: map branch (surfels + OT + primitive pose evidence) --
    L_lidar, h_lidar, map_certs, map_extras = map_evidence_fn(
        deskewed_points, deskewed_weights, batch, z_lin_pose_world, belief_pred
    )
    # Shift to chart coordinates (h = L @ (z_lin + r); see the note above).
    # The map factor is linearized at its OWN refined pose (Gauss-Newton
    # rounds inside the map branch), so the shift uses that pose's chart
    # vector, not z_lin_22d.
    z_map_22d = z_lin_22d
    if map_extras is not None:
        z_map_chart = se3.se3_log(
            se3.se3_relative(map_extras.z_map_pose, belief_pred.X_anchor)
        )
        z_map_22d = z_lin_22d.at[C.IDX_POSE].set(z_map_chart)
    h_lidar = h_lidar + L_lidar @ z_map_22d
    ms = cfg.map_evidence_scale if map_scale is None else cfg.map_evidence_scale * map_scale
    L_lidar = ms * L_lidar
    h_lidar = ms * h_lidar
    all_certs.extend(map_certs)

    # LiDAR measurement-noise IW suffstats (third block; reference
    # measurement_noise_iw_jax.py:104-131 applied via pipeline.py:550-566):
    # weighted outer products of the association translation residuals at the
    # map factor's final linearization.
    if map_extras is not None:
        dPsi_l, dnu_l = iw.lidar_meas_suffstats(
            map_extras.lidar_residuals.reshape(-1, 3),
            map_extras.lidar_resid_w.reshape(-1),
            cfg.eps_mass,
        )
        dPsi_meas = dPsi_meas + dPsi_l
        dnu_meas = dnu_meas + dnu_l

    # --- Step 9: power tempering ----------------------------------------
    L_ev_raw = L_imu_odom + L_lidar
    h_ev_raw = h_imu_odom + h_lidar
    # Certified non-finite handling: the reference
    # fails fast on NaN at operator boundaries (backend/pipeline.py:547-548);
    # inside one jitted program the total-function equivalent is a
    # certificate trigger + continuous rejection — a non-finite evidence
    # block zeroes beta (prior-only fusion this scan) and sets the
    # NonFiniteEvidence bit in the tape instead of laundering NaN into eps.
    # The certificate channel feeds beta/alpha (ess, excitation, sentinels):
    # a NaN there poisons the fusion controls even when L/h are finite
    # (observed: one non-finite cert field -> beta=NaN -> state poisoned
    # permanently). Guard BOTH channels.
    # NaN only — an inf in a purely diagnostic field (e.g. a cond ratio
    # overflowing in f32) must not silently reject the scan; the control
    # inputs (beta/alpha) are additionally scrubbed via CT.scrub below.
    certs_finite = jnp.asarray(True)
    for _c in all_certs:
        for _leaf in jax.tree_util.tree_leaves(_c):
            if jnp.issubdtype(jnp.asarray(_leaf).dtype, jnp.floating):
                certs_finite = certs_finite & ~jnp.any(jnp.isnan(_leaf))
    ev_finite = (
        jnp.all(jnp.isfinite(L_ev_raw)) & jnp.all(jnp.isfinite(h_ev_raw)) & certs_finite
    ).astype(L_ev_raw.dtype)
    if inputs_finite is not None:
        # sensor-boundary non-finiteness (detected on the raw batch before
        # scrubbing) also rejects the scan's evidence
        ev_finite = ev_finite * inputs_finite.astype(L_ev_raw.dtype)
    nonfinite = 1.0 - ev_finite
    L_ev_raw = jnp.nan_to_num(L_ev_raw, nan=0.0, posinf=0.0, neginf=0.0)
    h_ev_raw = jnp.nan_to_num(h_ev_raw, nan=0.0, posinf=0.0, neginf=0.0)
    nan_cert = CT.make_cert(exact=True)._replace(
        exact=ev_finite,
        triggers=(nonfinite > 0).astype(jnp.uint64)
        * jnp.uint64(CT.TRIGGERS["NonFiniteEvidence"]),
        n_triggers=nonfinite,
        mass_epsilon_ratio=nonfinite,  # counts toward trigger magnitude
    )
    all_certs.append(nan_cert)
    sentinels = fusion.observability_sentinels(L_ev_raw, cfg.eps_mass)
    evidence_cert = CT.scrub(
        CT.aggregate([deskew_cert, odom_cert, grav_cert, gyro_cert] + map_certs)
    )
    exc_total = evidence_cert.exc_dt_effect + evidence_cert.exc_ex_effect
    beta, temper_cert = fusion.power_tempering_beta(
        sentinels, evidence_cert.ess_total, exc_total,
        cfg.power_beta_min, cfg.power_beta_exc_c, cfg.power_beta_z_c, cfg.eps_mass,
    )
    all_certs.append(temper_cert)
    if beta_scale is not None:
        beta = beta * beta_scale  # per-hypothesis evidence-trust profile
    # prior-only when evidence was non-finite; `where`, not `*` — beta itself
    # can be NaN when the NaN arrived via the cert channel (NaN * 0 = NaN)
    beta = jnp.where(ev_finite > 0, beta, 0.0)
    L_evidence = beta * L_ev_raw
    h_evidence = beta * h_ev_raw

    # --- Step 10: excitation prior scaling -------------------------------
    s_dt, s_ex = fusion.excitation_scales(L_evidence, belief_pred.L)
    L_prior_scaled, h_prior_scaled, exc_cert = fusion.apply_excitation_prior_scaling(
        belief_pred.L, belief_pred.h, s_dt, s_ex
    )
    all_certs.append(exc_cert)
    belief_pred = belief_pred._replace(L=L_prior_scaled, h=h_prior_scaled)

    # --- Step 11: fusion alpha (pose-block conditioning) ------------------
    L_pose6 = linalg.sym(L_evidence[C.IDX_POSE, C.IDX_POSE])
    L_pose6 = jnp.nan_to_num(L_pose6, nan=0.0, posinf=0.0, neginf=0.0)
    eig_pose = jnp.linalg.eigvalsh(L_pose6)
    eig_pose = jnp.maximum(jnp.nan_to_num(eig_pose, nan=cfg.eps_psd), cfg.eps_psd)
    eigmin_pose6 = eig_pose[0]
    cond_pose6 = eig_pose[-1] / eig_pose[0]
    ess_to_exc = evidence_cert.ess_total / (exc_total + cfg.eps_mass)

    alpha, alpha_cert = fusion.fusion_alpha(
        cond_pose6, evidence_cert.ess_total, evidence_cert.support_frac, exc_total,
        sentinels.dt_asymmetry, sentinels.z_to_xy_ratio, beta, evidence_cert.nll_per_ess,
        cfg.alpha_min, cfg.alpha_max, cfg.c0_cond, cfg.eps_mass,
    )
    # rejected scan: evidence is zero, pin alpha at the conservative floor
    alpha = jnp.where(ev_finite > 0, alpha, cfg.alpha_min)
    all_certs.append(alpha_cert)

    # --- Step 12: additive info fusion ------------------------------------
    L_post, h_post, fusion_cert = fusion.info_fusion_additive(
        belief_pred.L, belief_pred.h, L_evidence, h_evidence, alpha, cfg.eps_psd
    )
    all_certs.append(fusion_cert)
    belief_post = belief_pred._replace(L=L_post, h=h_post)

    # --- ExpectedEffect channel (reference certificates.py:488): every
    # operator's predicted effect recorded NEXT TO the realized one so the
    # audit can compare them. Two pipeline-level objectives:
    #   pose_shift: predicted = first-order fused increment |delta_pose|;
    #               realized  = BCH3-corrected shift actually recomposed.
    #   info_gain:  predicted = alpha * tr(L_evidence) the fusion claims;
    #               realized  = tr(L_post) - tr(L_prior) after PSD projection.
    ee_pose_pred = jnp.linalg.norm(
        mean_increment(belief_post, cfg.eps_lift)[C.IDX_POSE]
    )
    ee_gain_pred = alpha * jnp.trace(L_evidence)
    ee_gain_real = jnp.trace(L_post) - jnp.trace(L_prior_scaled)

    # --- Step 13: Frobenius recompose --------------------------------------
    # NaN-safe: a non-finite magnitude would flow into the recompose budget
    # and poison the state; the NonFiniteEvidence bit already records it.
    total_mag = jnp.nan_to_num(
        CT.total_trigger_magnitude(all_certs), nan=0.0, posinf=0.0, neginf=0.0
    )
    rec, rec_cert = recompose.pose_update_frobenius_recompose(
        belief_post, total_mag, cfg.c_frob, cfg.eps_lift
    )
    all_certs.append(rec_cert)
    belief_rec = rec.belief
    ee_pose_real = jnp.linalg.norm(rec.delta_pose)

    # --- Step 14: process IW suffstats (commutative) ------------------------
    dPsi_proc, dnu_proc = iw.process_iw_suffstats(
        belief_pred.L, belief_pred.h, belief_rec.L, belief_rec.h, cfg.eps_lift,
        L_evidence,
    )

    # --- Step 16: anchor drift ----------------------------------------------
    drift, drift_cert = recompose.anchor_drift_update(
        belief_rec, C.ANCHOR_DRIFT_M0, C.ANCHOR_DRIFT_R0, cfg.eps_lift
    )
    all_certs.append(drift_cert)

    cert_agg = CT.scrub(CT.aggregate(all_certs))
    return HypOutputs(
        belief=drift.belief,
        dPsi_proc=dPsi_proc,
        dnu_proc=dnu_proc,
        dPsi_meas=dPsi_meas,
        dnu_meas=dnu_meas,
        cert_agg=cert_agg,
        total_trigger_mag=jnp.nan_to_num(
            CT.total_trigger_magnitude(all_certs), nan=0.0, posinf=0.0, neginf=0.0
        ),
        cond_pose6=cond_pose6,
        eigmin_pose6=eigmin_pose6,
        alpha=alpha,
        beta=beta,
        sent_dt_asym=sentinels.dt_asymmetry,
        sent_z_ratio=sentinels.z_to_xy_ratio,
        ess_to_exc=ess_to_exc,
        s_dt=s_dt,
        s_ex=s_ex,
        ee_pose_shift_pred=ee_pose_pred,
        ee_pose_shift_real=ee_pose_real,
        ee_info_gain_pred=ee_gain_pred,
        ee_info_gain_real=ee_gain_real,
        z_t_pose=world_pose(drift.belief, cfg.eps_lift),
        map_extras=map_extras,
    )


def _shared_extraction_inputs(b0: Belief, batch: ScanBatch, view, cfg, sensor_var):
    """Hypothesis-0 deskew pre-pass feeding the SHARED surfel extraction +
    shortlist (cfg.map_share_extraction): soft scan window -> preintegrated
    constant twist -> deskew, mirroring steps 3-5 of _hypothesis_step for
    hypothesis 0 only. The shortlist is taken at hypothesis 0's predicted
    world pose (mean-preserving under diffusion; IMU-increment under
    imu_predict) — per-hypothesis z_lin differs from it by at most the
    odom/evidence correction, absorbed by cfg.shortlist_margin_m."""
    from gcslam_tpu.models import atlas as atlas_mod
    from gcslam_tpu.ops.deskew import deskew_constant_twist

    _, Sigma0, _ = to_moments(b0, cfg.eps_lift)
    dt_std = jnp.sqrt(jnp.abs(Sigma0[C.IDX_DT, C.IDX_DT]))
    warp_cap = jnp.maximum(0.25 * batch.dt_sec, 0.01)
    sigma_warp = jnp.clip(dt_std, 0.01, warp_cap)
    w_scan = smooth_window_weights(
        batch.imu_stamps, batch.scan_start_time, batch.scan_end_time, sigma_warp
    )
    mu0 = mean_increment(b0, cfg.eps_lift)
    pose0 = world_pose(b0, cfg.eps_lift)
    gravity_W = jnp.asarray(C.GRAVITY_W, dtype=BELIEF_DTYPE) * cfg.imu_gravity_scale
    dt_imu = imu_mean_sample_period(batch.imu_stamps)
    dt_cov = imu_integration_time(
        batch.imu_stamps, batch.scan_start_time, batch.scan_end_time
    )
    target_scan = jnp.minimum(
        jnp.maximum(batch.scan_end_time - batch.scan_start_time, 0.0), dt_cov + dt_imu
    )
    pre_scan = preintegrate(
        batch.imu_stamps, batch.imu_gyro, batch.imu_accel, w_scan,
        pose0[3:6], mu0[C.IDX_BG], mu0[C.IDX_BA], gravity_W, target_scan,
    )
    xi_body = se3.se3_log(pre_scan.delta_pose)
    if cfg.deskew_rotation_only:
        xi_body = xi_body.at[:3].set(0.0)
    dsk_pts, dsk_w, _dsk_cert = deskew_constant_twist(
        batch.points, batch.point_stamps, batch.point_weights,
        batch.scan_start_time, batch.scan_end_time, xi_body, pre_scan.ess,
    )
    if cfg.imu_mode == "predict":
        w_int = smooth_window_weights(
            batch.imu_stamps, batch.t_last_scan, batch.t_scan, sigma_warp
        )
        dt_int = imu_integration_time(batch.imu_stamps, batch.t_last_scan, batch.t_scan)
        target_int = jnp.minimum(
            jnp.maximum(batch.t_scan - batch.t_last_scan, 0.0), dt_int + dt_imu
        )
        pre_int = preintegrate(
            batch.imu_stamps, batch.imu_gyro, batch.imu_accel, w_int,
            pose0[3:6], mu0[C.IDX_BG], mu0[C.IDX_BA], gravity_W, target_int,
        )
        z_center = se3.se3_compose(pose0, pre_int.delta_pose)
    else:
        z_center = pose0
    inputs = atlas_mod.build_measurement_inputs(
        dsk_pts, batch.point_stamps, dsk_w, batch, view, z_center, cfg, sensor_var
    )
    return inputs, z_center


def _zero_map_evidence(deskewed_points, deskewed_weights, batch, z_lin_pose, belief_pred):
    """No-map config: zero LiDAR evidence (eps-regularized like the
    reference's empty path, pipeline.py:1013-1015)."""
    L = C.EPS_LIFT * jnp.eye(C.D_Z, dtype=BELIEF_DTYPE)
    h = jnp.zeros((C.D_Z,), dtype=BELIEF_DTYPE)
    return L, h, [], None


def scan_step(
    state: StepState, batch: ScanBatch, config: PipelineConfig
) -> Tuple[StepState, StepOutput]:
    """One full scan: vmapped hypotheses -> barycenter -> IW apply -> map update."""
    cfg = config

    # Sensor-boundary non-finite check (reference fail-fast at operator
    # boundaries, pipeline.py:547-548): detect on the RAW batch, scrub to
    # finite values so the chart algebra stays total, and reject the scan's
    # evidence via the NonFiniteEvidence trigger + beta=0 in the hypothesis
    # step (prior-only fusion — never silent laundering).
    def _is_float(x):
        return jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)

    batch_finite = jnp.asarray(True)
    for leaf in jax.tree_util.tree_leaves(batch):
        if _is_float(leaf):
            batch_finite = batch_finite & jnp.all(jnp.isfinite(leaf))
    batch = jax.tree_util.tree_map(
        lambda x: jnp.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        if _is_float(x) else x,
        batch,
    )

    # Shared per-scan noise (from IW states; hypothesis-independent)
    Q = iw.process_noise_to_Q(state.process_iw, cfg.eps_psd)
    Sigma_g = iw.measurement_noise_mode(state.meas_iw, 0, cfg.eps_psd)
    Sigma_a = iw.measurement_noise_mode(state.meas_iw, 1, cfg.eps_psd)
    Sigma_l = iw.measurement_noise_mode(state.meas_iw, 2, cfg.eps_psd)

    atlas = state.atlas
    if cfg.with_map:
        from gcslam_tpu.models import atlas as atlas_mod
        from gcslam_tpu.ops import tiling

        # Active/stencil tile set around hypothesis 0's pose (the prediction
        # preserves the mean, so previous pose == predicted pose center).
        b0 = jax.tree_util.tree_map(lambda x: x[0], state.beliefs)
        center = world_pose(b0, cfg.eps_lift)[:3]
        active_ids = tiling.stencil_tile_ids(center, cfg.r_active_xy, cfg.r_active_z, cfg.h_tile)
        atlas, active_slots = atlas_mod.allocate_tiles(atlas, active_ids, batch.scan_seq)
        atlas, _downscale = atlas_mod.recency_inflate(atlas, active_slots, batch.scan_seq, cfg)
        view = atlas_mod.extract_view(
            atlas, active_slots, jnp.ones_like(active_slots, dtype=bool), cfg
        )
        sensor_var = jnp.trace(Sigma_l) / 3.0
        if cfg.map_share_extraction:
            shared, z_center = _shared_extraction_inputs(b0, batch, view, cfg, sensor_var)
        else:
            shared, z_center = None, None
        if cfg.map_gn_shared:
            # One GN chain per SCAN from hypothesis 0's predicted pose
            # (config.map_gn_shared): every hypothesis receives the same
            # alignment factor; the per-hypothesis chart shift and the
            # diversified map_scale/beta still differentiate its application.
            mb_s, sl_s, sc_s = shared
            sc_s = sc_s._replace(
                triggers=sc_s.triggers
                | jnp.uint64(CT.TRIGGERS["hyp_shared_extraction"])
            )
            gn_out = atlas_mod.map_gn_evidence(
                mb_s, sl_s, sc_s, view, batch.scan_seq, z_center, cfg
            )
            map_fn = lambda *args: gn_out
        else:
            map_fn = atlas_mod.make_map_evidence_fn(
                view, cfg, sensor_var=sensor_var, shared=shared
            )
    else:
        map_fn = _zero_map_evidence

    if cfg.hyp_diversify and cfg.k_hyp == len(C.HYP_BETA_SCALE):
        beta_scales = jnp.asarray(C.HYP_BETA_SCALE, dtype=BELIEF_DTYPE)
        map_scales = jnp.asarray(C.HYP_MAP_EVIDENCE_SCALE, dtype=BELIEF_DTYPE)
    else:
        beta_scales = jnp.ones((cfg.k_hyp,), dtype=BELIEF_DTYPE)
        map_scales = jnp.ones((cfg.k_hyp,), dtype=BELIEF_DTYPE)
    hyp_fn = lambda b, bs, ms: _hypothesis_step(
        b, batch, Q, Sigma_g, Sigma_a, map_fn, cfg,
        inputs_finite=batch_finite, beta_scale=bs, map_scale=ms,
    )
    hyp_out = jax.vmap(hyp_fn)(state.beliefs, beta_scales, map_scales)

    # Per-scan weight update from evidence fit (soft Bayes factor on the
    # mismatch statistic), floored + renormalized. With hyp_diversify off
    # the hypotheses are identical, nll ties, and weights stay put —
    # reference parity (weights never updated, backend_node.py:823).
    if cfg.hyp_diversify:
        ll = -C.HYP_WEIGHT_LL_GAIN * hyp_out.cert_agg.nll_per_ess
        w_upd = state.hyp_weights * jnp.exp(ll - jnp.max(ll))
        w_upd = jnp.maximum(w_upd / jnp.sum(w_upd), C.HYP_WEIGHT_FLOOR)
        hyp_weights = w_upd / jnp.sum(w_upd)
    else:
        hyp_weights = state.hyp_weights

    # Hypothesis barycenter -> published belief
    bary, bary_cert = hypothesis_barycenter(
        hyp_out.belief, hyp_weights, C.HYP_WEIGHT_FLOOR, cfg.eps_psd, cfg.eps_lift
    )
    pose = world_pose(bary.belief, cfg.eps_lift)

    # IW apply once per scan, hypothesis-weight-averaged suffstats
    # (backend_node.py:2093-2119); process weight 0 at scan 0.
    w = hyp_weights / jnp.sum(hyp_weights)
    dPsi_proc = jnp.einsum("k,kbij->bij", w, hyp_out.dPsi_proc)
    dnu_proc = jnp.einsum("k,kb->b", w, hyp_out.dnu_proc)
    dPsi_meas = jnp.einsum("k,kbij->bij", w, hyp_out.dPsi_meas)
    dnu_meas = jnp.einsum("k,kb->b", w, hyp_out.dnu_meas)
    w_process = jnp.minimum(1.0, state.scan_count.astype(BELIEF_DTYPE))
    process_iw, _ = iw.process_iw_apply(
        state.process_iw, w_process * dPsi_proc, w_process * dnu_proc, cfg.eps_psd
    )
    meas_iw, _ = iw.measurement_iw_apply(state.meas_iw, dPsi_meas, dnu_meas, cfg.eps_psd)

    # Map update from hypothesis 0 (backend_node.py:2080-2086)
    if cfg.with_map:
        extras0 = jax.tree_util.tree_map(lambda x: x[0], hyp_out.map_extras)
        z_t0 = hyp_out.z_t_pose[0]
        atlas_new, map_tape = atlas_mod.map_update_step(
            atlas, view, extras0, z_t0, active_slots, active_ids,
            batch.scan_seq, batch.scan_end_time, cfg,
        )
    else:
        atlas_new = atlas
        zero = jnp.zeros((), dtype=BELIEF_DTYPE)
        map_tape = dict(
            fused_mass=zero, insert_mass=zero, evicted_mass=zero,
            n_culled=zero, n_merged=zero, valid_total=zero,
            ot_transport_mass=zero, ot_marginal_defect_a=zero,
            ins_ids=jnp.zeros((0,), dtype=jnp.int32),
            ins_tiles=jnp.zeros((0,), dtype=jnp.int64),
            ins_mu=jnp.zeros((0, 3), dtype=jnp.float32),
            ins_w=jnp.zeros((0,), dtype=jnp.float32),
        )

    # Cross-hypothesis cert aggregation for the tape (weighted-mean style)
    def wmean(x):
        return jnp.einsum("k,k->", w, x)

    agg = hyp_out.cert_agg
    tape = ScanTape(
        timestamp=batch.t_scan,
        dt_sec=batch.dt_sec,
        fusion_alpha=wmean(hyp_out.alpha),
        power_beta=wmean(hyp_out.beta),
        cond_pose6=wmean(hyp_out.cond_pose6),
        eigmin_pose6=wmean(hyp_out.eigmin_pose6),
        total_trigger_magnitude=jnp.sum(hyp_out.total_trigger_mag),
        cert_exact=jnp.min(agg.exact),
        cert_frobenius_applied=jnp.max(agg.frobenius_applied),
        cert_n_triggers=jnp.sum(agg.n_triggers),
        cert_triggers=agg.triggers[0],
        support_ess_total=wmean(agg.ess_total),
        support_frac=wmean(agg.support_frac),
        mismatch_nll_per_ess=wmean(agg.nll_per_ess),
        mismatch_directional_score=wmean(agg.directional_score),
        excitation_dt_effect=wmean(agg.exc_dt_effect),
        excitation_extrinsic_effect=wmean(agg.exc_ex_effect),
        influence_psd_projection_delta=wmean(agg.psd_projection_delta),
        influence_anchor_drift_rho=jnp.max(agg.anchor_drift_rho),
        influence_dt_scale=wmean(1.0 - hyp_out.s_dt),
        influence_extrinsic_scale=wmean(1.0 - hyp_out.s_ex),
        overconfidence_dt_asymmetry=wmean(hyp_out.sent_dt_asym),
        overconfidence_z_to_xy_ratio=wmean(hyp_out.sent_z_ratio),
        overconfidence_ess_to_excitation=wmean(hyp_out.ess_to_exc),
        hyp_spread=bary.spread_proxy,
        ee_pose_shift_pred=wmean(hyp_out.ee_pose_shift_pred),
        ee_pose_shift_real=wmean(hyp_out.ee_pose_shift_real),
        ee_info_gain_pred=wmean(hyp_out.ee_info_gain_pred),
        ee_info_gain_real=wmean(hyp_out.ee_info_gain_real),
        map_fused_mass=map_tape["fused_mass"],
        map_insert_mass=map_tape["insert_mass"],
        map_evicted_mass=map_tape["evicted_mass"],
        map_n_culled=map_tape["n_culled"],
        map_n_merged=map_tape["n_merged"],
        map_valid_total=map_tape["valid_total"],
        ot_transport_mass=map_tape["ot_transport_mass"],
        ot_marginal_defect_a=map_tape["ot_marginal_defect_a"],
        map_ins_ids=map_tape["ins_ids"],
        map_ins_tiles=map_tape["ins_tiles"],
        map_ins_mu=map_tape["ins_mu"],
        map_ins_w=map_tape["ins_w"],
        io_n_points_valid=jnp.sum((batch.point_weights > 0).astype(BELIEF_DTYPE)),
        io_n_imu_valid=jnp.sum((batch.imu_stamps > 0).astype(BELIEF_DTYPE)),
        io_imu_coverage=imu_integration_time(
            batch.imu_stamps, batch.t_last_scan, batch.t_scan
        ) / jnp.maximum(batch.dt_sec, 1e-9),
        io_n_cam_valid=jnp.sum(batch.cam_valid.astype(BELIEF_DTYPE)),
        io_loop_weight=batch.loop_weight.astype(BELIEF_DTYPE),
        io_point_weight_sum=jnp.sum(batch.point_weights).astype(BELIEF_DTYPE),
    )

    state_new = StepState(
        beliefs=hyp_out.belief,
        hyp_weights=hyp_weights,
        process_iw=process_iw,
        meas_iw=meas_iw,
        atlas=atlas_new,
        scan_count=state.scan_count + 1,
    )
    return state_new, StepOutput(pose=pose, stamp=batch.t_scan, tape=tape)


def init_state(config: PipelineConfig, stamp: float = 0.0, X_anchor=None) -> StepState:
    """K_HYP identity-prior beliefs + datasheet IW states (+ empty atlas)."""
    from gcslam_tpu.models.belief import identity_prior

    b0 = identity_prior(stamp)
    if X_anchor is not None:
        b0 = b0._replace(X_anchor=jnp.asarray(X_anchor, dtype=BELIEF_DTYPE))
    beliefs = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (config.k_hyp,) + x.shape), b0
    )
    if config.with_map:
        from gcslam_tpu.models import atlas as atlas_mod

        atlas0 = atlas_mod.empty_atlas(config)
    else:
        atlas0 = None
    return StepState(
        beliefs=beliefs,
        hyp_weights=jnp.ones((config.k_hyp,), dtype=BELIEF_DTYPE) / config.k_hyp,
        process_iw=iw.datasheet_process_noise(),
        meas_iw=iw.datasheet_measurement_noise(),
        atlas=atlas0,
        scan_count=jnp.zeros((), dtype=jnp.int32),
    )
