"""Golden-trajectory cross-validation of eval/ate_rpe.py.

The reference scores with evo (tools/evaluate_slam.py:220-380); our in-repo
reimplementation must be provably convention-compatible — a wrong sign or
frame convention here silently corrupts every accuracy claim. evo is not
installable in this environment, so each case injects a KNOWN error into a
ground-truth trajectory and asserts the computed ATE/RPE/diagnosis equals the
analytically expected value; rotation math is additionally cross-checked
against scipy.spatial.transform.Rotation (an independent implementation).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as Rsc

from gcslam_tpu.eval import ate_rpe


def _mk_gt(n=120, seed=0):
    """Smooth non-planar trajectory with nontrivial rotations."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 4 * np.pi, n)
    trans = np.stack([5 * np.cos(s), 5 * np.sin(s), 0.3 * s], axis=1)
    yaw = s + np.pi / 2
    rotvec = np.stack([0.05 * np.sin(s), 0.05 * np.cos(s), yaw], axis=1)
    # rotvec composition via scipy to keep |rotvec| continuous
    rv = Rsc.from_euler("xyz", np.stack([0.05 * np.sin(s), 0.05 * np.cos(s), yaw], axis=1)).as_rotvec()
    del rotvec, rng
    return np.concatenate([trans, rv], axis=1)


def _apply_left(T_R, T_t, poses):
    """Left-multiply a rigid transform onto every pose [trans, rotvec]."""
    R = Rsc.from_rotvec(poses[:, 3:6]).as_matrix()
    R_new = np.einsum("ij,njk->nik", T_R, R)
    t_new = poses[:, :3] @ T_R.T + T_t
    return np.concatenate([t_new, Rsc.from_matrix(R_new).as_rotvec()], axis=1)


# ---------------------------------------------------------------------------
# ATE
# ---------------------------------------------------------------------------


def test_ate_zero_on_identical():
    gt = _mk_gt()
    for align in ("none", "initial", "umeyama"):
        ate = ate_rpe.compute_ate(gt.copy(), gt, align=align)
        assert ate["translation"]["rmse"] < 1e-9
        assert ate["rotation_deg"]["rmse"] < 1e-6
        assert not ate["rot_offset_180_suspect"]


def test_ate_fixed_translation_offset_unaligned():
    """est = gt + [0.3, -0.4, 0] -> ATE trans exactly 0.5 m, rotation 0."""
    gt = _mk_gt()
    est = gt.copy()
    est[:, 0] += 0.3
    est[:, 1] += -0.4
    ate = ate_rpe.compute_ate(est, gt, align="none")
    assert ate["translation"]["rmse"] == pytest.approx(0.5, abs=1e-12)
    assert ate["translation"]["max"] == pytest.approx(0.5, abs=1e-12)
    assert ate["rotation_deg"]["rmse"] < 1e-6
    # per-axis errors carry the injected per-axis magnitudes
    assert ate["per_axis"]["x"]["rmse"] == pytest.approx(0.3, abs=1e-12)
    assert ate["per_axis"]["y"]["rmse"] == pytest.approx(0.4, abs=1e-12)
    assert ate["per_axis"]["z"]["rmse"] < 1e-12


def test_ate_initial_alignment_removes_constant_se3_offset():
    """A constant LEFT SE(3) error is exactly removed by initial-pose
    alignment (the reference's default mode, evaluate_slam.py:235-271)."""
    gt = _mk_gt()
    T_R = Rsc.from_euler("xyz", [0.2, -0.1, 0.7]).as_matrix()
    T_t = np.array([1.0, -2.0, 0.5])
    est = _apply_left(T_R, T_t, gt)
    ate = ate_rpe.compute_ate(est, gt, align="initial")
    assert ate["translation"]["rmse"] < 1e-9
    assert ate["rotation_deg"]["rmse"] < 1e-6


def test_ate_umeyama_removes_rigid_offset():
    gt = _mk_gt()
    T_R = Rsc.from_euler("zyx", [1.1, 0.3, -0.2]).as_matrix()
    T_t = np.array([-3.0, 4.0, 1.0])
    est = _apply_left(T_R, T_t, gt)
    ate = ate_rpe.compute_ate(est, gt, align="umeyama")
    assert ate["translation"]["rmse"] < 1e-9


def test_ate_180_flip_diagnosis():
    """A constant 180-deg yaw flip (axis-swap frame mismatch) must trip the
    rot_offset_180_suspect diagnosis (reference evaluate_slam.py:273) and
    report ~180 deg rotation ATE."""
    gt = _mk_gt()
    flip = Rsc.from_euler("z", np.pi).as_matrix()
    est = gt.copy()
    R = Rsc.from_rotvec(gt[:, 3:6]).as_matrix()
    est[:, 3:6] = Rsc.from_matrix(np.einsum("ij,njk->nik", flip, R)).as_rotvec()
    ate = ate_rpe.compute_ate(est, gt, align="none")
    assert ate["rot_offset_180_suspect"]
    assert ate["rotation_deg"]["median"] == pytest.approx(180.0, abs=1e-6)


def test_ate_rotation_error_matches_scipy():
    """Rotation ATE values cross-checked against an independent
    implementation (scipy): geodesic angle of Rg Re^T."""
    gt = _mk_gt()
    rng = np.random.default_rng(7)
    est = gt.copy()
    pert = Rsc.from_rotvec(0.05 * rng.standard_normal((len(gt), 3)))
    R_e = pert.as_matrix() @ Rsc.from_rotvec(gt[:, 3:6]).as_matrix()
    est[:, 3:6] = Rsc.from_matrix(R_e).as_rotvec()
    ate = ate_rpe.compute_ate(est, gt, align="none")
    R_g = Rsc.from_rotvec(gt[:, 3:6]).as_matrix()
    ang = Rsc.from_matrix(np.einsum("nij,nkj->nik", R_g, R_e)).magnitude()
    expect_rmse = np.sqrt(np.mean(np.degrees(ang) ** 2))
    assert ate["rotation_deg"]["rmse"] == pytest.approx(expect_rmse, rel=1e-9)


# ---------------------------------------------------------------------------
# RPE
# ---------------------------------------------------------------------------


def _straight_line(n=101, step=0.5):
    """GT: straight x-axis line, identity rotation, step m per scan."""
    t = np.arange(n) * step
    poses = np.zeros((n, 6))
    poses[:, 0] = t
    return poses


def test_rpe_zero_on_identical():
    gt = _mk_gt()
    rpe = ate_rpe.compute_rpe(gt.copy(), gt, deltas_m=[1.0, 5.0])
    for key in ("1m", "5m"):
        assert rpe[key]["n_pairs"] > 0
        assert rpe[key]["translation"]["rmse"] < 1e-9


def test_rpe_linear_drift_analytic():
    """est drifts +d per scan along y: over a window of k scans the relative
    translation error is exactly k*d (identity rotations)."""
    step, d = 0.5, 0.01
    gt = _straight_line(n=101, step=step)
    est = gt.copy()
    est[:, 1] += d * np.arange(len(gt))
    rpe = ate_rpe.compute_rpe(est, gt, deltas_m=[1.0, 5.0])
    # 1 m of path = 2 scans -> error 2*d; 5 m = 10 scans -> 10*d.
    assert rpe["1m"]["translation"]["rmse"] == pytest.approx(2 * d, abs=1e-12)
    assert rpe["5m"]["translation"]["rmse"] == pytest.approx(10 * d, abs=1e-12)
    assert rpe["1m"]["rotation_deg"]["rmse"] < 1e-9


def test_rpe_constant_offset_invisible():
    """RPE is invariant to a CONSTANT pose offset (it scores relative motion
    only — the property that distinguishes it from ATE)."""
    gt = _mk_gt()
    T_R = Rsc.from_euler("z", 0.8).as_matrix()
    est = _apply_left(T_R, np.array([2.0, -1.0, 3.0]), gt)
    rpe = ate_rpe.compute_rpe(est, gt, deltas_m=[1.0])
    assert rpe["1m"]["translation"]["rmse"] < 1e-9
    assert rpe["1m"]["rotation_deg"]["rmse"] < 1e-6


def test_rpe_rotation_drift_analytic():
    """est yaw drifts +phi per scan: windowed relative rotation error is
    exactly k*phi degrees."""
    step = 1.0
    phi = np.radians(0.1)
    gt = _straight_line(n=51, step=step)
    est = gt.copy()
    est[:, 5] = phi * np.arange(len(gt))
    rpe = ate_rpe.compute_rpe(est, gt, deltas_m=[1.0, 5.0])
    assert rpe["1m"]["rotation_deg"]["rmse"] == pytest.approx(0.1, abs=1e-9)
    assert rpe["5m"]["rotation_deg"]["rmse"] == pytest.approx(0.5, abs=1e-9)


# ---------------------------------------------------------------------------
# Internal rotation helpers vs scipy (independent implementation)
# ---------------------------------------------------------------------------


def test_rotvec_roundtrip_vs_scipy():
    rng = np.random.default_rng(3)
    rv = rng.standard_normal((256, 3))
    # include near-pi magnitudes
    rv[:32] = rv[:32] / np.linalg.norm(rv[:32], axis=1, keepdims=True) * 3.14
    R_ours = ate_rpe._rotvec_to_R(rv)
    R_scipy = Rsc.from_rotvec(rv).as_matrix()
    np.testing.assert_allclose(R_ours, R_scipy, atol=1e-12)
    rv_back = ate_rpe._R_to_rotvec(R_scipy)
    ang_ours = Rsc.from_rotvec(rv_back)
    ang_in = Rsc.from_rotvec(rv)
    # compare as rotations (rotvec has a +/- pi ambiguity at the boundary)
    diff = (ang_ours * ang_in.inv()).magnitude()
    assert np.max(diff) < 1e-9
