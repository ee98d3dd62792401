"""Primitive association via unbalanced Sinkhorn OT over the stencil pool.

Parity map (reference operators/primitive_association.py:105-553):
  - cost C[i,k] = ||x_i - x_k||^2 + beta * Hellinger^2_vMF via Bhattacharyya
    of vMF natural params (A(k_m) - (A(k1)+A(k2))/2 with stable log-sinh);
  - recency cost bias epsilon * lambda * dt_scan (continuous, no gates);
  - deterministic top-K_ASSOC downselect by cost (top_k ties break by lowest
    pool index — the reference additionally tie-breaks on recency/primitive
    id, which only matters on exact cost ties);
  - fixed-K unbalanced Sinkhorn (tau_a/tau_b KL relaxation, K=50, no
    convergence check); responsibilities = pi directly (NO row
    normalization — row_masses carry novelty semantics, spec 5.7.3).

Array-program deviation: candidates are scored against the WHOLE stencil
pool (N x S*M_VIEW cost tile — one big fused elementwise+reduce) instead of the reference's per-measurement hex-stencil re-lookup; the stencil
restriction is recovered by the distance term itself (candidates outside the
measurement's neighborhood lose by cost). Pool rows are masked by validity.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from gcslam_tpu.utils.xla import jax, jnp, BELIEF_DTYPE, POINT_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.models.batch import MeasurementBatch, mean_positions, mean_directions, kappas
from gcslam_tpu.ops.certs import Cert, make_cert, TRIGGERS
from gcslam_tpu.ops.sinkhorn_pallas import resolve_backend, sinkhorn_unbalanced_pallas


class AssociationResult(NamedTuple):
    responsibilities: jnp.ndarray  # (N, K)
    cand_pool: jnp.ndarray  # (N, K) int32 pool rows
    cand_sl: jnp.ndarray  # (N, K) int32 rows into the shortlist (== cand_pool
    # on the full-pool path); lets downstream evidence gather candidate
    # attributes from the dense CandidateSet instead of re-gathering the pool
    row_masses: jnp.ndarray  # (N,)
    cost: jnp.ndarray  # (N, K)
    transport_mass: jnp.ndarray  # ()
    marginal_defect_a: jnp.ndarray  # ()
    ess_ot: jnp.ndarray  # ()


class CandidateSet(NamedTuple):
    """Pose-INVARIANT candidate attributes, gathered once per scan.

    The GN anneal re-associates every round, but the shortlist indices — and
    therefore every per-candidate attribute — are fixed across rounds; only
    the measurement-side transport (pose) changes. Gathering (N, Ks) rows
    from the (P,) pool inside the round body made the random-access gathers
    the dominant per-round cost. `pos/dirs/weights` keep the view dtype (f64-clean in
    reference-precision mode); the cost-only channels are POINT_DTYPE."""

    idx: jnp.ndarray  # (N, Ks) int32 pool rows
    pos: jnp.ndarray  # (N, Ks, 3) world positions (view dtype)
    dirs: jnp.ndarray  # (N, Ks, 3) directions (view dtype)
    weights: jnp.ndarray  # (N, Ks) view weights (view dtype)
    kap: jnp.ndarray  # (N, Ks) POINT_DTYPE
    eta: jnp.ndarray  # (N, Ks, 3) kappa * direction, POINT_DTYPE
    eta_sq: jnp.ndarray  # (N, Ks) sum(eta^2)
    A_k2: jnp.ndarray  # (N, Ks) log_A_vmf(max(kap, 1e-12))
    last_supported: jnp.ndarray  # (N, Ks) int32
    valid: jnp.ndarray  # (N, Ks) bool
    # LiDAR mass fraction of the candidate slot (AtlasView.lidar_frac);
    # None when the view carries none = treat as all-LiDAR.
    lidar_frac: jnp.ndarray = None  # (N, Ks)


def gather_candidates(view, idx: jnp.ndarray) -> CandidateSet:
    """One-shot (N, Ks) gather of every round-invariant candidate attribute
    (+ the cost terms derivable from them: eta, |eta|^2, A(kappa))."""
    p32 = POINT_DTYPE
    ckap = view.kappas[idx].astype(p32)
    ceta = (view.kappas[:, None] * view.directions)[idx].astype(p32)
    return CandidateSet(
        idx=idx,
        pos=view.positions[idx],
        dirs=view.directions[idx],
        weights=view.weights[idx],
        kap=ckap,
        eta=ceta,
        eta_sq=jnp.sum(ceta**2, axis=-1),
        A_k2=_log_A_vmf(jnp.maximum(ckap, 1e-12)),
        last_supported=view.last_supported[idx],
        valid=view.valid[idx],
        lidar_frac=None if view.lidar_frac is None else view.lidar_frac[idx],
    )


def _log_A_vmf(k: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """A(k) = log(4 pi) + log(sinh k) - log k, numerically stable."""
    k = jnp.maximum(k, eps)
    log_sinh = jnp.where(
        k > 20.0,
        k - jnp.log(2.0),
        jnp.where(k >= 1e-2, jnp.log(jnp.sinh(k)), jnp.log(k + k**3 / 6.0)),
    )
    return jnp.log(4.0 * jnp.pi) + log_sinh - jnp.log(k)


def _topk_blocked(x: jnp.ndarray, k: int, block: int = 512):
    """Exact top-k over the last axis via two-level reduction.

    Splitting a wide axis into `block`-wide chunks (top-k per chunk, then
    top-k over the chunk winners) gives values identical to one wide top_k
    while every selection stays narrow. Tie handling matches lax.top_k's
    lowest-index-wins: chunk winners are ordered (chunk, within-chunk), so
    the global lowest index wins exact ties."""
    *lead, P = x.shape
    if P <= max(2 * block, 2 * k):
        return jax.lax.top_k(x, k)
    pad = (-P) % block
    if pad:
        x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, pad)], constant_values=-jnp.inf)
    B = (P + pad) // block
    xb = x.reshape(*lead, B, block)
    v1, i1 = jax.lax.top_k(xb, min(k, block))  # (..., B, k)
    base = (jnp.arange(B, dtype=jnp.int32) * block)[:, None]
    g1 = (i1.astype(jnp.int32) + base).reshape(*lead, -1)  # global indices
    v2, i2 = jax.lax.top_k(v1.reshape(*lead, -1), k)
    idx = jnp.take_along_axis(g1, i2, axis=-1)
    return v2, idx


def shortlist_candidates(
    meas_pos_world: jnp.ndarray,  # (N, 3) measurement means, WORLD frame
    meas_valid: jnp.ndarray,  # (N,) bool
    view,  # AtlasView
    cfg,
) -> jnp.ndarray:
    """Distance-only candidate shortlist: (N, k_shortlist) pool rows.

    Computed ONCE per hypothesis (at the map-branch linearization pose) and
    reused by every GN round — the (N, P) work happens here and only here.
    Selection is by squared world distance with the stencil-reach cutoff
    (+ shortlist_margin_m for later GN pose motion); invalid pool rows rank
    last. Recency/direction terms are intentionally absent: they can only
    reorder candidates within an O(ot_cost_beta) cost band, which
    k_shortlist >> k_assoc absorbs (declared shortlist_pruning trigger on
    the association cert)."""
    p32 = POINT_DTYPE
    mp = meas_pos_world.astype(p32)
    vp = view.positions.astype(p32)
    d = (
        jnp.sum(mp * mp, axis=1)[:, None]
        - 2.0 * mp @ vp.T
        + jnp.sum(vp * vp, axis=1)[None, :]
    )  # (N, P)
    reach = 2.0 * cfg.h_tile * (cfg.r_stencil_xy + 0.5) + cfg.shortlist_margin_m
    ok = view.valid[None, :] & meas_valid[:, None] & (d < reach * reach)
    d = jnp.where(ok, d, jnp.inf)
    k = min(cfg.k_shortlist, d.shape[-1])
    _, idx = _topk_blocked(-d, k)
    return idx.astype(jnp.int32)


def _sinkhorn_unbalanced(C_mat, a, b, epsilon, tau_a, tau_b, n_iters: int):
    eps = jnp.maximum(epsilon, 1e-12)
    K_mat = jnp.exp(-C_mat / eps)
    ua = 1.0 / (1.0 + tau_a / eps)
    vb = 1.0 / (1.0 + tau_b / eps)

    def it(_, uv):
        u, v = uv
        u = (a / (K_mat @ v + 1e-12)) ** ua
        v = (b / (K_mat.T @ u + 1e-12)) ** vb
        return u, v

    u0 = jnp.ones_like(a)
    v0 = jnp.ones_like(b)
    # unroll: the body is a pair of tiny (N,K) matvec updates — while-loop
    # boundary overhead dominates the math, so run several exact iterations
    # per loop trip (same fixed K total, contract unchanged).
    u, v = jax.lax.fori_loop(0, n_iters, it, (u0, v0), unroll=10)
    return u[:, None] * K_mat * v[None, :]


def associate_primitives_ot(
    batch: MeasurementBatch,
    view,  # AtlasView
    scan_seq: jnp.ndarray,
    cfg,
    z_lin_pose: jnp.ndarray = None,  # (6,) world pose; None if batch is world
    shortlist: jnp.ndarray = None,  # (N, Ks) pool rows from shortlist_candidates
) -> Tuple[AssociationResult, Cert]:
    f = BELIEF_DTYPE
    N = batch.valid.shape[0]
    K = cfg.k_assoc

    meas_pos = mean_positions(batch, cfg.eps_lift)  # (N, 3) body frame
    meas_dir = mean_directions(batch, cfg.eps_mass)
    meas_kap = kappas(batch)
    valid_f = batch.valid.astype(f)
    if z_lin_pose is not None:
        # Measurements live in the scan-end body frame; the view pool is
        # world-frame. Transport both position and direction through the
        # linearization pose (reference primitive_association.py:241-258
        # does this per-candidate inside its stencil loop).
        from gcslam_tpu.ops import se3 as _se3

        R0 = _se3.so3_exp(z_lin_pose[3:6])
        meas_pos = meas_pos @ R0.T + z_lin_pose[:3][None, :]
        meas_dir = meas_dir @ R0.T

    p32 = POINT_DTYPE
    mp = meas_pos.astype(p32)
    meas_eta = (meas_kap[:, None] * meas_dir).astype(p32)  # (N, 3)
    # Locality gate: the reference restricts candidates to the hex-stencil
    # tiles around each MEASUREMENT (primitive_association.py:307-365) — that
    # restriction is what gives unmatched measurements zero transported mass
    # (novelty -> insertion). Reproduce it as an absolute distance cutoff at
    # the stencil reach (2 tiles).
    reach_sq = (2.0 * cfg.h_tile * (cfg.r_stencil_xy + 0.5)) ** 2
    recency_w = cfg.ot_epsilon * cfg.recency_decay_lambda

    if shortlist is None:
        dt_pool = jnp.maximum(
            0, scan_seq.astype(jnp.int32) - view.last_supported
        ).astype(p32)
        # --- full-pool cost tile (f32 for the big part) -------------------
        vp = view.positions.astype(p32)
        d_pos = (
            jnp.sum(mp * mp, axis=1)[:, None]
            - 2.0 * mp @ vp.T
            + jnp.sum(vp * vp, axis=1)[None, :]
        )  # (N, P)
        view_eta = (view.kappas[:, None] * view.directions).astype(p32)  # (P, 3)
        # k_m = 0.5 ||eta_i + eta_k||: expand the norm, keep it matmul-shaped.
        cross = meas_eta @ view_eta.T  # (N, P)
        km = 0.5 * jnp.sqrt(
            jnp.maximum(
                jnp.sum(meas_eta**2, axis=1)[:, None]
                + jnp.sum(view_eta**2, axis=1)[None, :]
                + 2.0 * cross,
                1e-24,
            )
        )
        A_km = _log_A_vmf(km)
        A_k1 = _log_A_vmf(jnp.maximum(meas_kap.astype(p32), 1e-12))[:, None]
        A_k2 = _log_A_vmf(jnp.maximum(view.kappas.astype(p32), 1e-12))[None, :]
        bc = jnp.exp(A_km - 0.5 * (A_k1 + A_k2))
        d_dir = jnp.maximum(0.0, 1.0 - bc)
        dir_on = ((meas_kap[:, None] > 0) & (view.kappas[None, :] > 0)).astype(p32)
        cost_pool = d_pos + cfg.ot_cost_beta * d_dir * dir_on
        cost_pool = cost_pool + recency_w * dt_pool[None, :]
        pool_ok = view.valid[None, :] & batch.valid[:, None] & (d_pos < reach_sq)
        cost_pool = jnp.where(pool_ok, cost_pool, 1e12)

        # --- deterministic top-K candidates --------------------------------
        neg_top, cand = _topk_blocked(-cost_pool, K)  # (N, K)
        cost = (-neg_top).astype(f)
        cand = cand.astype(jnp.int32)
        cand_sl = cand  # full-pool path: shortlist rows ARE pool rows
        cand_valid = jnp.take_along_axis(pool_ok, cand, axis=1)
    else:
        # --- shortlisted cost tile (N, Ks): same math, NO in-round gathers —
        # every candidate attribute was gathered once per scan into the
        # CandidateSet (gather_candidates); the round only recomputes the
        # pose-dependent terms (distance, eta cross term, recency dt).
        cs = shortlist  # CandidateSet
        sl = cs.idx  # (N, Ks) pool rows
        cpos = cs.pos.astype(p32)  # (N, Ks, 3)
        diff = mp[:, None, :] - cpos
        d_pos = jnp.sum(diff * diff, axis=-1)  # (N, Ks)
        km = 0.5 * jnp.sqrt(
            jnp.maximum(
                jnp.sum(meas_eta**2, axis=1)[:, None]
                + cs.eta_sq
                + 2.0 * jnp.einsum("ni,nki->nk", meas_eta, cs.eta),
                1e-24,
            )
        )
        A_km = _log_A_vmf(km)
        A_k1 = _log_A_vmf(jnp.maximum(meas_kap.astype(p32), 1e-12))[:, None]
        bc = jnp.exp(A_km - 0.5 * (A_k1 + cs.A_k2))
        d_dir = jnp.maximum(0.0, 1.0 - bc)
        dir_on = ((meas_kap[:, None] > 0) & (cs.kap > 0)).astype(p32)
        cost_sl = d_pos + cfg.ot_cost_beta * d_dir * dir_on
        dt_sl = jnp.maximum(
            0, scan_seq.astype(jnp.int32) - cs.last_supported
        ).astype(p32)
        cost_sl = cost_sl + recency_w * dt_sl
        sl_ok = cs.valid & batch.valid[:, None] & (d_pos < reach_sq)
        cost_sl = jnp.where(sl_ok, cost_sl, 1e12)

        neg_top, ci = jax.lax.top_k(-cost_sl, K)  # within the shortlist
        cost = (-neg_top).astype(f)
        cand = jnp.take_along_axis(sl, ci, axis=1).astype(jnp.int32)
        cand_sl = ci.astype(jnp.int32)
        cand_valid = jnp.take_along_axis(sl_ok, ci, axis=1)

    # Optional row-min subtraction (reference cost normalization,
    # primitive_association.py:401-404; off by default — see PipelineConfig),
    # re-masking invalid/out-of-reach candidates afterwards so the
    # subtraction can never zero a masked entry.
    if cfg.ot_subtract_row_min:
        row_min = jnp.min(jnp.where(cand_valid, cost, jnp.inf), axis=1, keepdims=True)
        row_min = jnp.where(jnp.isfinite(row_min), row_min, 0.0)
        cost_n = jnp.where(cand_valid, cost - row_min, 1e12)
    else:
        cost_n = jnp.where(cand_valid, cost, 1e12)

    # --- marginals (UNIFORM policies, spec 5.7.2) ---------------------------
    sum_a = jnp.maximum(jnp.sum(valid_f), cfg.eps_mass)
    a = valid_f / sum_a
    b = jnp.full((K,), 1.0 / K, dtype=f)

    backend = resolve_backend(cfg.sinkhorn_backend, jax.default_backend(), cost_n.dtype)
    sinkhorn = sinkhorn_unbalanced_pallas if backend == "pallas" else _sinkhorn_unbalanced
    pi = sinkhorn(
        cost_n, a, b, cfg.ot_epsilon, cfg.ot_tau_a, cfg.ot_tau_b, cfg.k_sinkhorn
    )
    pi = pi * cand_valid.astype(f)
    row_masses = jnp.sum(pi, axis=1)

    transport_mass = jnp.sum(pi)
    marginal_defect_a = jnp.linalg.norm(row_masses - a)
    ess_ot = jnp.sum(row_masses) ** 2 / (jnp.sum(row_masses**2) + cfg.eps_mass)

    result = AssociationResult(
        responsibilities=pi,
        cand_pool=cand,
        cand_sl=cand_sl,
        row_masses=row_masses,
        cost=cost_n,
        transport_mass=transport_mass,
        marginal_defect_a=marginal_defect_a,
        ess_ot=ess_ot,
    )
    triggers = TRIGGERS["sinkhorn_fixed_iter"] | TRIGGERS["sinkhorn_unbalanced_kl_relax"]
    if shortlist is not None:
        triggers |= TRIGGERS["shortlist_pruning"]
    cert = make_cert(
        exact=False,
        triggers=triggers,
        ess_total=ess_ot,
        support_frac=jnp.sum(valid_f) / N,
        mass_epsilon_ratio=cfg.eps_mass / (transport_mass + cfg.eps_mass),
    )
    return result, cert
