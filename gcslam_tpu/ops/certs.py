"""Certificate pytrees — the audit layer, jit-native.

The reference carries per-operator Python `CertBundle` dataclasses with
string trigger lists (fl_slam_poc/common/certificates.py:349-540). Inside a
single jitted scan step that design is impossible, so here:

  - a certificate is a flat numeric NamedTuple (`Cert`) — a pytree of 0-d
    arrays that flows through jit and stacks naturally under vmap/lax.scan;
  - approximation triggers are a uint64 BITMASK; the name<->bit registry
    (`TRIGGERS`) decodes them at the boundary (diagnostics/manifest);
  - `aggregate([...])` reproduces the reference aggregation semantics
    (certificates.py:511-560): worst-case conditioning, mean support,
    summed mismatch/influence, OR'd triggers.

`trigger_magnitude` mirrors CertBundle.total_trigger_magnitude
(certificates.py:440-455): the sum of influence magnitudes that indicate
approximation, used for the Frobenius recompose strength.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

from gcslam_tpu.utils.xla import jnp, BELIEF_DTYPE

# ---------------------------------------------------------------------------
# Trigger registry (string <-> bit). Order is the decode order.
# ---------------------------------------------------------------------------
TRIGGER_NAMES = [
    "MomentToInfo",
    "PointBudgetResample",
    "PredictDiffusion",
    "ImuAccelDirectionTimeResolved",
    "TransportConsistencyWeighting",
    "KappaLowRApproximation",
    "ImuDependenceInflation",
    "ImuGyroRotationGaussian",
    "ImuPreintegrationVelPos",
    "OdomEvidenceGaussian",
    "OdomVelocityEvidence",
    "OdomYawRateEvidence",
    "PoseTwistKinematicConsistency",
    "OdomDependenceInflation",
    "PlanarZPrior",
    "VelocityZPrior",
    "ma_hex3d_binning",
    "plane_fit_batched",
    "wishart_regularization",
    "sinkhorn_fixed_iter",
    "sinkhorn_unbalanced_kl_relax",
    "linearization",
    "ot_soft_correspondence",
    "PowerTempering",
    "ExcitationPriorScaling",
    "InfoFusionAdditive",
    "PoseUpdateFrobeniusRecompose",
    "AnchorDriftUpdate",
    "HypothesisProjection",
    "budgeting",
    "mass_drop",
    "merge_reduce",
    "NonFiniteEvidence",
    "shortlist_pruning",
    "hyp_shared_extraction",
]
TRIGGERS = {name: 1 << i for i, name in enumerate(TRIGGER_NAMES)}


def decode_triggers(mask: int) -> list[str]:
    return [name for name, bit in TRIGGERS.items() if int(mask) & bit]


class Cert(NamedTuple):
    """Flat numeric certificate (all fields 0-d arrays of BELIEF_DTYPE,
    except `triggers` which is uint64)."""

    exact: jnp.ndarray
    frobenius_applied: jnp.ndarray
    triggers: jnp.ndarray  # uint64 bitmask
    n_triggers: jnp.ndarray
    # conditioning (certificates.py:22-36)
    eig_min: jnp.ndarray
    eig_max: jnp.ndarray
    cond: jnp.ndarray
    near_null_count: jnp.ndarray
    # support (certificates.py:39-49)
    ess_total: jnp.ndarray
    support_frac: jnp.ndarray
    # mismatch (certificates.py:52-62)
    nll_per_ess: jnp.ndarray
    directional_score: jnp.ndarray
    # excitation (certificates.py:65-75)
    exc_dt_effect: jnp.ndarray
    exc_ex_effect: jnp.ndarray
    # influence (certificates.py:78-109)
    lift_strength: jnp.ndarray
    psd_projection_delta: jnp.ndarray
    nu_projection_delta: jnp.ndarray
    mass_epsilon_ratio: jnp.ndarray
    anchor_drift_rho: jnp.ndarray
    dt_scale: jnp.ndarray
    ex_scale: jnp.ndarray
    trust_alpha: jnp.ndarray
    power_beta: jnp.ndarray


def _s(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=BELIEF_DTYPE)


def make_cert(
    exact: bool | jnp.ndarray = True,
    triggers: int = 0,
    frobenius_applied=0.0,
    eig_min=0.0,
    eig_max=0.0,
    cond=1.0,
    near_null_count=0.0,
    ess_total=0.0,
    support_frac=1.0,
    nll_per_ess=0.0,
    directional_score=0.0,
    exc_dt_effect=0.0,
    exc_ex_effect=0.0,
    lift_strength=0.0,
    psd_projection_delta=0.0,
    nu_projection_delta=0.0,
    mass_epsilon_ratio=0.0,
    anchor_drift_rho=0.0,
    dt_scale=1.0,
    ex_scale=1.0,
    trust_alpha=1.0,
    power_beta=1.0,
) -> Cert:
    n_trig = bin(int(triggers)).count("1")
    return Cert(
        exact=_s(exact),
        frobenius_applied=_s(frobenius_applied),
        triggers=jnp.asarray(triggers, dtype=jnp.uint64),
        n_triggers=_s(n_trig),
        eig_min=_s(eig_min),
        eig_max=_s(eig_max),
        cond=_s(cond),
        near_null_count=_s(near_null_count),
        ess_total=_s(ess_total),
        support_frac=_s(support_frac),
        nll_per_ess=_s(nll_per_ess),
        directional_score=_s(directional_score),
        exc_dt_effect=_s(exc_dt_effect),
        exc_ex_effect=_s(exc_ex_effect),
        lift_strength=_s(lift_strength),
        psd_projection_delta=_s(psd_projection_delta),
        nu_projection_delta=_s(nu_projection_delta),
        mass_epsilon_ratio=_s(mass_epsilon_ratio),
        anchor_drift_rho=_s(anchor_drift_rho),
        dt_scale=_s(dt_scale),
        ex_scale=_s(ex_scale),
        trust_alpha=_s(trust_alpha),
        power_beta=_s(power_beta),
    )


def trigger_magnitude(c: Cert) -> jnp.ndarray:
    """Sum of influence magnitudes indicating approximation
    (reference certificates.py:440-455)."""
    return (
        c.lift_strength
        + c.psd_projection_delta
        + c.nu_projection_delta
        + c.mass_epsilon_ratio
        + c.anchor_drift_rho
        + jnp.abs(1.0 - c.dt_scale)
        + jnp.abs(1.0 - c.ex_scale)
        + jnp.abs(1.0 - c.trust_alpha)
        + jnp.abs(1.0 - c.power_beta)
    )


def aggregate(certs: Sequence[Cert]) -> Cert:
    """Aggregate operator certificates (reference certificates.py:511-560).

    The list has static length inside jit — this compiles to a handful of
    elementwise min/max/sum ops.
    """
    assert len(certs) > 0
    stk = Cert(*[jnp.stack([getattr(c, f) for c in certs]) for f in Cert._fields])
    mask = stk.triggers[0]
    for i in range(1, len(certs)):
        mask = mask | stk.triggers[i]
    n = float(len(certs))
    return Cert(
        exact=jnp.min(stk.exact),
        frobenius_applied=jnp.max(stk.frobenius_applied),
        triggers=mask,
        n_triggers=jnp.sum(stk.n_triggers),
        eig_min=jnp.min(stk.eig_min),
        eig_max=jnp.max(stk.eig_max),
        cond=jnp.max(stk.cond),
        near_null_count=jnp.sum(stk.near_null_count),
        ess_total=jnp.sum(stk.ess_total) / n,
        support_frac=jnp.sum(stk.support_frac) / n,
        nll_per_ess=jnp.sum(stk.nll_per_ess),
        directional_score=jnp.sum(stk.directional_score) / n,
        exc_dt_effect=jnp.sum(stk.exc_dt_effect),
        exc_ex_effect=jnp.sum(stk.exc_ex_effect),
        lift_strength=jnp.sum(stk.lift_strength),
        psd_projection_delta=jnp.sum(stk.psd_projection_delta),
        nu_projection_delta=jnp.sum(stk.nu_projection_delta),
        mass_epsilon_ratio=jnp.sum(stk.mass_epsilon_ratio),
        anchor_drift_rho=jnp.max(stk.anchor_drift_rho),
        dt_scale=jnp.min(stk.dt_scale),
        ex_scale=jnp.min(stk.ex_scale),
        trust_alpha=jnp.min(stk.trust_alpha),
        power_beta=jnp.min(stk.power_beta),
    )


def scrub(cert: Cert) -> Cert:
    """Replace non-finite float fields with 0 (triggers/int fields pass
    through). Used at the aggregation boundary AFTER the NonFiniteEvidence
    detection: a NaN in the cert channel would otherwise poison beta/alpha
    and the tape even though the evidence itself was rejected."""
    import jax

    def f(x):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        return x

    return jax.tree_util.tree_map(f, cert)


def total_trigger_magnitude(certs: Sequence[Cert]) -> jnp.ndarray:
    """Sum of per-operator trigger magnitudes (pipeline.py:1211)."""
    out = trigger_magnitude(certs[0])
    for c in certs[1:]:
        out = out + trigger_magnitude(c)
    return out
