"""The reference's contract-test families, exercised on the REAL scan_step
(reference test/test_audit_invariants.py:1-463, test_budget_assertions.py:1-118,
test_cert_schema.py:1-294):

  - certified non-finite handling (NaN in evidence => trigger + prior-only)
  - no-gates smoothness: extreme outliers produce CONTINUOUS output changes
  - IW suffstats commutativity under hypothesis permutation
  - cert-schema completeness vs the trigger registry
  - budget/alloc assertions: every state/tape array matches declared budgets
"""

import numpy as np
import pytest

from gcslam_tpu.utils.xla import jax, jnp
from gcslam_tpu import constants as C
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.models.scan_step import init_state, ScanTape
from gcslam_tpu.ops import certs as CT
from gcslam_tpu.ops import iw
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

SMALL = dict(
    with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64,
    n_surfel=128, surfel_voxel_size_m=0.5,
)


@pytest.fixture(scope="module")
def small_run():
    return generate(SyntheticConfig(n_scans=6, n_points=512))


# ---------------------------------------------------------------------------
# Certified non-finite evidence
# ---------------------------------------------------------------------------


def test_nan_evidence_sets_trigger_and_goes_prior_only(small_run):
    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    state, out0 = runner._step_jit(state, small_run.batches[0], cfg)

    bad = small_run.batches[1]._replace(
        odom_pose=jnp.asarray([np.nan, 0, 0, 0, 0, 0], dtype=jnp.float64)
    )
    state, out = runner._step_jit(state, bad, cfg)
    trig = int(np.asarray(out.tape.cert_triggers))
    assert trig & CT.TRIGGERS["NonFiniteEvidence"], "NaN must set the trigger bit"
    assert float(np.asarray(out.tape.power_beta)) == 0.0, "prior-only fusion"
    assert np.all(np.isfinite(np.asarray(out.pose)))
    for f in ScanTape._fields:
        assert np.all(np.isfinite(np.asarray(getattr(out.tape, f)).astype(np.float64))), f

    # recovery: the next clean scan fuses evidence again, no sticky state
    state, out2 = runner._step_jit(state, small_run.batches[2], cfg)
    assert not int(np.asarray(out2.tape.cert_triggers)) & CT.TRIGGERS["NonFiniteEvidence"]
    assert float(np.asarray(out2.tape.power_beta)) > 0.0
    assert np.all(np.isfinite(np.asarray(out2.pose)))


def test_clean_run_has_no_nonfinite_trigger(small_run):
    cfg = PipelineConfig(**SMALL)
    _, out = runner.run_bag(small_run.batches, cfg)
    masks = np.asarray(out.tape.cert_triggers).astype(np.int64)
    assert not np.any(masks & CT.TRIGGERS["NonFiniteEvidence"])


# ---------------------------------------------------------------------------
# No-gates smoothness (reference test_audit_invariants.py: the identity
# contract — no threshold can flip the output discontinuously)
# ---------------------------------------------------------------------------


def test_no_gates_smoothness_under_outlier_sweep(small_run):
    """Sweep an odom outlier magnitude over 4 orders; the pose response must
    be continuous in the outlier (adjacent magnitudes give nearby poses,
    with the response SATURATING — not jumping — as the outlier grows)."""
    cfg = PipelineConfig(**SMALL)
    state0 = init_state(cfg)
    state0, _ = runner._step_jit(state0, small_run.batches[0], cfg)

    mags = np.concatenate([[0.0], np.logspace(-3, 1, 13)])
    poses = []
    for m in mags:
        b = small_run.batches[1]
        b = b._replace(odom_pose=b.odom_pose + jnp.asarray([m, 0, 0, 0, 0, 0]))
        _, out = runner._step_jit(state0, b, cfg)
        poses.append(np.asarray(out.pose))
    poses = np.stack(poses)
    assert np.all(np.isfinite(poses))
    deltas = np.linalg.norm(np.diff(poses[:, :3], axis=0), axis=1)
    step_ratio = np.diff(mags)
    # continuity: each pose step is bounded by the outlier step (no gate can
    # amplify a small input change into a large output jump)
    assert np.all(deltas <= 2.0 * step_ratio + 1e-6), (
        f"discontinuous response: {deltas} vs input steps {step_ratio}")


# ---------------------------------------------------------------------------
# IW commutativity under hypothesis permutation
# ---------------------------------------------------------------------------


def test_iw_apply_commutes_under_hypothesis_permutation():
    """The per-scan IW update consumes hypothesis-weighted suffstats; any
    permutation of hypotheses (with matched weights) must give the same
    posterior IW state (reference test_audit_invariants.py IW family)."""
    rng = np.random.default_rng(7)
    K = 4
    dPsi = rng.normal(size=(K, 7, 6, 6))
    dPsi = dPsi + np.swapaxes(dPsi, -1, -2)  # symmetric
    dnu = np.abs(rng.normal(size=(K, 7)))
    w = np.abs(rng.normal(size=K)) + 0.1
    w = w / w.sum()

    def combined(perm):
        s = iw.datasheet_process_noise()
        dP = sum(w[k] * dPsi[perm[k]] for k in range(K))
        dn = sum(w[k] * dnu[perm[k]] for k in range(K))
        # match weights to permuted stats
        wp = w[list(perm)]
        dP = sum(wp[k] * dPsi[perm[k]] for k in range(K))
        dn = sum(wp[k] * dnu[perm[k]] for k in range(K))
        out, _ = iw.process_iw_apply(s, jnp.asarray(dP), jnp.asarray(dn))
        return out

    a = combined([0, 1, 2, 3])
    b = combined([3, 1, 0, 2])
    np.testing.assert_allclose(np.asarray(a.Psi), np.asarray(b.Psi), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a.nu), np.asarray(b.nu), rtol=1e-12)


def test_iw_suffstats_addition_order_invariant():
    """Suffstats are commutative by construction: accumulating evidence
    deltas in any order yields the same (Psi, nu)."""
    rng = np.random.default_rng(11)
    terms = [rng.normal(size=(7, 6, 6)) for _ in range(5)]
    terms = [t + np.swapaxes(t, -1, -2) for t in terms]
    s = iw.datasheet_process_noise()
    fwd = np.sum(terms, axis=0)
    rev = np.sum(terms[::-1], axis=0)
    a, _ = iw.process_iw_apply(s, jnp.asarray(fwd), jnp.ones(7))
    b, _ = iw.process_iw_apply(s, jnp.asarray(rev), jnp.ones(7))
    np.testing.assert_allclose(np.asarray(a.Psi), np.asarray(b.Psi), rtol=1e-12)


# ---------------------------------------------------------------------------
# Cert schema completeness (reference test_cert_schema.py)
# ---------------------------------------------------------------------------


def test_trigger_registry_bits_unique_and_decodable():
    bits = list(CT.TRIGGERS.values())
    assert len(set(bits)) == len(bits)
    assert len(CT.TRIGGER_NAMES) <= 64, "uint64 bitmask"
    all_mask = 0
    for b in bits:
        all_mask |= b
    assert set(CT.decode_triggers(all_mask)) == set(CT.TRIGGER_NAMES)
    assert CT.decode_triggers(0) == []


def test_make_cert_schema_complete_and_aggregation_preserves_it():
    c1 = CT.make_cert(exact=False, triggers=CT.TRIGGERS["linearization"],
                      ess_total=5.0, cond=10.0)
    c2 = CT.make_cert(exact=True, triggers=CT.TRIGGERS["mass_drop"], cond=100.0)
    agg = CT.aggregate([c1, c2])
    assert set(agg._fields) == set(CT.Cert._fields)
    for f in CT.Cert._fields:
        v = np.asarray(getattr(agg, f))
        assert v.shape == (), f
        assert np.isfinite(v.astype(np.float64)), f
    mask = int(np.asarray(agg.triggers))
    assert set(CT.decode_triggers(mask)) == {"linearization", "mass_drop"}
    assert float(np.asarray(agg.exact)) == 0.0  # any inexact => inexact
    assert float(np.asarray(agg.cond)) == 100.0  # worst case


def test_triggers_imply_frobenius_on_scan(small_run):
    """approximation_triggers != empty => frobenius recompose applied
    (AGENTS.md:99-102 contract)."""
    cfg = PipelineConfig(**SMALL)
    _, out = runner.run_bag(small_run.batches, cfg)
    n_trig = np.asarray(out.tape.cert_n_triggers)
    frob = np.asarray(out.tape.cert_frobenius_applied)
    assert np.all((n_trig == 0) | (frob > 0))


# ---------------------------------------------------------------------------
# ExpectedEffect: predicted vs realized (reference certificates.py:488)
# ---------------------------------------------------------------------------


def test_expected_effect_predicted_tracks_realized(small_run):
    """The recomposed pose shift must track the fused increment the pipeline
    predicted (BCH3 is third-order: realized ~= predicted for small shifts),
    and realized info gain never exceeds the claimed alpha*tr(L_ev)."""
    cfg = PipelineConfig(**SMALL)
    _, out = runner.run_bag(small_run.batches, cfg)
    pred = np.asarray(out.tape.ee_pose_shift_pred)
    real = np.asarray(out.tape.ee_pose_shift_real)
    sig = pred > 1e-6
    assert np.any(sig), "run produced no significant pose shifts"
    ratio = real[sig] / pred[sig]
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    gp = np.asarray(out.tape.ee_info_gain_pred)
    gr = np.asarray(out.tape.ee_info_gain_real)
    assert np.all(gr <= gp * 1.05 + 1e-6)
    assert np.any(gp > 0)


# ---------------------------------------------------------------------------
# Budget / alloc assertions (reference test_budget_assertions.py)
# ---------------------------------------------------------------------------


def test_state_and_tape_shapes_match_declared_budgets(small_run):
    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    assert state.beliefs.L.shape == (C.K_HYP, C.D_Z, C.D_Z)
    assert state.beliefs.h.shape == (C.K_HYP, C.D_Z)
    assert state.hyp_weights.shape == (C.K_HYP,)
    assert state.process_iw.Psi.shape == (7, 6, 6)
    assert state.meas_iw.Psi.shape == (3, 3, 3)
    a = state.atlas
    assert a.Lambdas.shape == (cfg.atlas_max_tiles, cfg.m_tile, 3, 3)
    assert a.tile_ids.shape == (cfg.atlas_max_tiles,)

    state, out = runner._step_jit(state, small_run.batches[0], cfg)
    # all tape fields are scalar except the fixed-budget per-insertion event
    # payloads (reference pipeline.py:1393-1410 logs per-insert rows):
    # (A*Kin,) vectors with id=-1 marking unused rows
    per_insert = {"map_ins_ids": (), "map_ins_tiles": (), "map_ins_mu": (3,),
                  "map_ins_w": ()}
    n_ins = np.asarray(out.tape.map_ins_ids).shape[0]
    assert n_ins > 0 and n_ins % cfg.k_insert_tile == 0, n_ins
    for f in ScanTape._fields:
        got = np.asarray(getattr(out.tape, f)).shape
        if f in per_insert:
            assert got == (n_ins,) + per_insert[f], (f, got)
        else:
            assert got == (), f

    b = small_run.batches[0]
    assert b.points.shape[0] <= C.N_POINTS_CAP
    assert b.imu_stamps.shape == (C.MAX_IMU_PREINT_LEN,)
    assert b.cam_Lambdas.shape == (C.N_FEAT, 3, 3)


def test_batch_budget_mismatch_fails_fast():
    with pytest.raises(ValueError, match="compiled constant"):
        PipelineConfig(k_hyp=C.K_HYP + 1).validate()
    with pytest.raises(ValueError, match="outside declared range"):
        PipelineConfig(forgetting_factor=1.5).validate()


def test_cert_channel_nan_rejected(small_run, monkeypatch):
    """A NaN arriving through the CERTIFICATE channel (not L/h) — e.g. an
    internal op emitting a non-finite ess/sentinel — must be rejected the
    same way: NonFiniteEvidence bit, beta=0, finite pose and tape, clean
    recovery. (Observed: one NaN cert field -> beta=NaN -> state
    poisoned permanently.)"""
    from gcslam_tpu.ops import evidence_imu

    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    state, _ = runner._step_jit(state, small_run.batches[0], cfg)

    real = evidence_imu.imu_gravity_evidence_time_resolved

    def poisoned(*a, **kw):
        grav, cert = real(*a, **kw)
        return grav, cert._replace(ess_total=jnp.asarray(np.nan, dtype=cert.ess_total.dtype))

    monkeypatch.setattr(evidence_imu, "imu_gravity_evidence_time_resolved", poisoned)
    import gcslam_tpu.models.scan_step as SS
    fn = jax.jit(lambda s, b: SS.scan_step(s, b, cfg))
    state, out = fn(state, small_run.batches[1])
    trig = int(np.asarray(out.tape.cert_triggers))
    assert trig & CT.TRIGGERS["NonFiniteEvidence"], "cert-channel NaN must trip the bit"
    assert float(np.asarray(out.tape.power_beta)) == 0.0
    assert np.all(np.isfinite(np.asarray(out.pose)))
    for f in ScanTape._fields:
        assert np.all(np.isfinite(np.asarray(getattr(out.tape, f)).astype(np.float64))), f

    monkeypatch.undo()
    state, out2 = runner._step_jit(state, small_run.batches[2], cfg)
    assert not int(np.asarray(out2.tape.cert_triggers)) & CT.TRIGGERS["NonFiniteEvidence"]
    assert np.all(np.isfinite(np.asarray(out2.pose)))
