"""Device-resident tiled primitive atlas + the whole map-side pipeline.

The reference keeps the map as a Python dict of 50k-slot tiles mutated by
per-tile/per-block Python loops (backend/structures/primitive_map.py:182-2031,
backend/pipeline.py:1258-1447 — its own docs flag those loops as the main
dispatch bottleneck). Here the atlas is a FIXED-CAPACITY HBM-resident
structure-of-arrays:

    tile table:  tile_ids (T,) int64 (-1 empty), LRU stamps (T,)
    primitives:  (T, M_TILE, ...) SoA — Gaussian info form (Lambda, theta),
                 multi-lobe vMF etas, mass/recency/provenance/color

so that EVERY map operation — recency inflation, view extraction, OT
association, fuse, insert-with-eviction, cull, forget, merge-reduce — is a
fixed-shape gather/scatter over the active-tile stencil, inside the one
jitted scan step. Tile allocation is deterministic: match > empty slot > LRU
eviction (evicted mass is certified, mirroring the reference's declared
budgeting approximations).

Capacity note: the reference atlas is unbounded (dict); this one holds
ATLAS_MAX_TILES tiles of M_TILE primitives. Tiles that fall out of the LRU
horizon are forgotten — a declared fixed-budget deviation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from gcslam_tpu.utils.xla import jax, jnp, BELIEF_DTYPE, POINT_DTYPE, TIME_DTYPE
from gcslam_tpu import constants as C
from gcslam_tpu.models.batch import MeasurementBatch, from_camera_and_surfels, mean_positions
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.ops import linalg, se3, tiling
from gcslam_tpu.ops.certs import make_cert, TRIGGERS
from gcslam_tpu.ops.surfels import extract_surfels

MAPF = POINT_DTYPE  # map storage dtype (f32: bulk point-path data)


class AtlasState(NamedTuple):
    tile_ids: jnp.ndarray  # (T,) int64, -1 = empty
    tile_last_active: jnp.ndarray  # (T,) int32 scan_seq for LRU
    Lambdas: jnp.ndarray  # (T, M, 3, 3)
    thetas: jnp.ndarray  # (T, M, 3)
    etas: jnp.ndarray  # (T, M, B, 3)
    weights: jnp.ndarray  # (T, M)
    timestamps: jnp.ndarray  # (T, M) TIME_DTYPE (f64 epoch seconds)
    created: jnp.ndarray  # (T, M) TIME_DTYPE
    last_supported: jnp.ndarray  # (T, M) int32 scan seq
    last_update: jnp.ndarray  # (T, M) int32
    primitive_ids: jnp.ndarray  # (T, M) int32, -1 invalid
    valid: jnp.ndarray  # (T, M) bool
    cam_mass: jnp.ndarray  # (T, M)
    lidar_mass: jnp.ndarray  # (T, M)
    rgb_accum: jnp.ndarray  # (T, M, 3) camera color numerator
    rgb_denom: jnp.ndarray  # (T, M)
    rgb: jnp.ndarray  # (T, M, 3) canonical color (camera-dominant)
    next_global_id: jnp.ndarray  # () int32


def empty_atlas(cfg: PipelineConfig) -> AtlasState:
    T, M, B = cfg.atlas_max_tiles, cfg.m_tile, C.VMF_N_LOBES
    return AtlasState(
        tile_ids=jnp.full((T,), -1, dtype=jnp.int64),
        tile_last_active=jnp.full((T,), -1, dtype=jnp.int32),
        Lambdas=jnp.zeros((T, M, 3, 3), dtype=MAPF),
        thetas=jnp.zeros((T, M, 3), dtype=MAPF),
        etas=jnp.zeros((T, M, B, 3), dtype=MAPF),
        weights=jnp.zeros((T, M), dtype=MAPF),
        timestamps=jnp.zeros((T, M), dtype=TIME_DTYPE),
        created=jnp.zeros((T, M), dtype=TIME_DTYPE),
        last_supported=jnp.zeros((T, M), dtype=jnp.int32),
        last_update=jnp.zeros((T, M), dtype=jnp.int32),
        primitive_ids=jnp.full((T, M), -1, dtype=jnp.int32),
        valid=jnp.zeros((T, M), dtype=bool),
        cam_mass=jnp.zeros((T, M), dtype=MAPF),
        lidar_mass=jnp.zeros((T, M), dtype=MAPF),
        rgb_accum=jnp.zeros((T, M, 3), dtype=MAPF),
        rgb_denom=jnp.zeros((T, M), dtype=MAPF),
        rgb=jnp.full((T, M, 3), 0.5, dtype=MAPF),
        next_global_id=jnp.zeros((), dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# Tile table ops
# ---------------------------------------------------------------------------


def lookup_tiles(atlas: AtlasState, query_ids: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(S,) int64 -> (slot (S,) int32, found (S,) bool). Misses return slot 0."""
    eq = atlas.tile_ids[None, :] == query_ids[:, None]  # (S, T)
    found = jnp.any(eq, axis=1)
    slot = jnp.argmax(eq, axis=1).astype(jnp.int32)
    return jnp.where(found, slot, 0), found


def allocate_tiles(
    atlas: AtlasState, query_ids: jnp.ndarray, scan_seq: jnp.ndarray
) -> Tuple[AtlasState, jnp.ndarray]:
    """Ensure all query tile ids have table slots. Deterministic policy:
    existing match > empty slot > least-recently-active eviction (the evicted
    tile's content is cleared). Returns (atlas', slots (S,) int32)."""
    S = query_ids.shape[0]
    T = atlas.tile_ids.shape[0]

    # The sequential dependency (query i+1 must not evict the slot query i
    # just claimed) only involves the two SMALL directory arrays; content
    # clearing is hoisted out of the loop into one batched masked update —
    # this removed a per-iteration lax.cond over 16 full-atlas writes that
    # dominated compile time.
    def body(i, carry):
        tile_ids, last_active, slots, was_new = carry
        qid = query_ids[i]
        eq = tile_ids == qid
        found = jnp.any(eq)
        match_slot = jnp.argmax(eq).astype(jnp.int32)
        # score: empty slots best (very old), then LRU
        busy = tile_ids >= 0
        score = jnp.where(busy, last_active, jnp.int32(-2_000_000_000))
        victim = jnp.argmin(score).astype(jnp.int32)
        slot = jnp.where(found, match_slot, victim)
        tile_ids = tile_ids.at[slot].set(qid)
        last_active = last_active.at[slot].set(scan_seq.astype(jnp.int32))
        return (tile_ids, last_active, slots.at[i].set(slot),
                was_new.at[i].set(~found))

    carry0 = (
        atlas.tile_ids,
        atlas.tile_last_active,
        jnp.zeros((S,), dtype=jnp.int32),
        jnp.zeros((S,), dtype=bool),
    )
    tile_ids, last_active, slots, was_new = jax.lax.fori_loop(0, S, body, carry0)

    # Newly-claimed slots get their content cleared by a SLOT-ROW scatter
    # (S rows), not a full-atlas where-pass: the previous clear_mask/where
    # formulation read+wrote every (T, M, ...) array each scan — one of the
    # O(T*M) passes that made the per-scan cost grow with total atlas size.
    # Rows for already-present tiles point out of bounds (T) and
    # are dropped; duplicate targets cannot occur (distinct new queries claim
    # distinct victims — claiming bumps last_active, so the next argmin moves).
    clear_slots = jnp.where(was_new, slots, jnp.int32(T))

    def zc(x, fill=0):
        upd = jnp.full((S,) + x.shape[1:], fill, dtype=x.dtype)
        return x.at[clear_slots].set(upd, mode="drop")

    atlas = atlas._replace(
        tile_ids=tile_ids,
        tile_last_active=last_active,
        Lambdas=zc(atlas.Lambdas),
        thetas=zc(atlas.thetas),
        etas=zc(atlas.etas),
        weights=zc(atlas.weights),
        timestamps=zc(atlas.timestamps),
        created=zc(atlas.created),
        last_supported=zc(atlas.last_supported),
        last_update=zc(atlas.last_update),
        primitive_ids=zc(atlas.primitive_ids, fill=-1),
        valid=zc(atlas.valid, fill=False),
        cam_mass=zc(atlas.cam_mass),
        lidar_mass=zc(atlas.lidar_mass),
        rgb_accum=zc(atlas.rgb_accum),
        rgb_denom=zc(atlas.rgb_denom),
        rgb=zc(atlas.rgb, fill=0.5),
    )
    return atlas, slots


# ---------------------------------------------------------------------------
# Recency inflation (reference primitive_map.py:1404-1486)
# ---------------------------------------------------------------------------


def recency_inflate(
    atlas: AtlasState, tile_slots: jnp.ndarray, scan_seq: jnp.ndarray, cfg: PipelineConfig
) -> Tuple[AtlasState, jnp.ndarray]:
    """Downscale precision of stale primitives in the given tiles:
    decay = clip(exp(-lambda dt_scan), min_scale, 1); mean-preserving
    (Lambda and theta scaled together). Returns (atlas', downscale_total)."""
    dt = jnp.maximum(0, scan_seq.astype(jnp.int32) - atlas.last_supported[tile_slots])
    decay = jnp.exp(-cfg.recency_decay_lambda * dt.astype(MAPF))
    decay = jnp.clip(decay, cfg.recency_min_scale, 1.0)
    decay = jnp.where(atlas.valid[tile_slots], decay, 1.0)  # (S, M)
    Lam = atlas.Lambdas.at[tile_slots].multiply(decay[..., None, None])
    th = atlas.thetas.at[tile_slots].multiply(decay[..., None])
    downscale = jnp.sum((1.0 - decay) * atlas.valid[tile_slots].astype(MAPF))
    return atlas._replace(Lambdas=Lam, thetas=th), downscale


# ---------------------------------------------------------------------------
# View extraction (reference extract_atlas_map_view, primitive_map.py:346-436)
# ---------------------------------------------------------------------------


class AtlasView(NamedTuple):
    """Fixed-size stitched candidate pool over the stencil tiles.

    Pool row p = tile_pos * m_view + k; addressing back into the atlas via
    (tile_slot[p], slot[p])."""

    positions: jnp.ndarray  # (P, 3) world, f64
    directions: jnp.ndarray  # (P, 3)
    kappas: jnp.ndarray  # (P,)
    weights: jnp.ndarray  # (P,)
    valid: jnp.ndarray  # (P,) bool
    primitive_ids: jnp.ndarray  # (P,) int32
    last_supported: jnp.ndarray  # (P,) int32
    tile_slot: jnp.ndarray  # (P,) int32 (atlas tile-table slot)
    slot: jnp.ndarray  # (P,) int32 (slot within tile)
    # LiDAR mass fraction of the slot (1 = pure surfel). Camera-dominant
    # slots carry viewing-ray directions, which are viewpoint-dependent and
    # must not vote in the rotation scatter (ops/evidence_pose.py). None on
    # hand-built views = treat as all-LiDAR.
    lidar_frac: jnp.ndarray = None  # (P,)


def extract_view(
    atlas: AtlasState, tile_slots: jnp.ndarray, tile_found: jnp.ndarray, cfg: PipelineConfig
) -> AtlasView:
    """Top m_tile_view slots per stencil tile by weight (deterministic
    tie-break by primitive id), stitched into one pool."""
    S = tile_slots.shape[0]
    V = cfg.m_tile_view

    w = atlas.weights[tile_slots]  # (S, M)
    valid = atlas.valid[tile_slots] & tile_found[:, None]
    pid = atlas.primitive_ids[tile_slots]
    score = jnp.where(valid, w, -jnp.inf)
    # top-V by weight; ties break by lowest index (slot order), matching the
    # reference's deterministic ordering intent.
    _, top_slots = jax.lax.top_k(score, V)  # (S, V)

    Lam = jnp.take_along_axis(atlas.Lambdas[tile_slots], top_slots[:, :, None, None], axis=1)
    th = jnp.take_along_axis(atlas.thetas[tile_slots], top_slots[:, :, None], axis=1)
    eta = jnp.take_along_axis(atlas.etas[tile_slots], top_slots[:, :, None, None], axis=1)
    wv = jnp.take_along_axis(w, top_slots, axis=1)
    vv = jnp.take_along_axis(valid, top_slots, axis=1)
    pv = jnp.take_along_axis(pid, top_slots, axis=1)
    ls = jnp.take_along_axis(atlas.last_supported[tile_slots], top_slots, axis=1)
    cm = jnp.take_along_axis(atlas.cam_mass[tile_slots], top_slots, axis=1)
    lm = jnp.take_along_axis(atlas.lidar_mass[tile_slots], top_slots, axis=1)

    f64 = BELIEF_DTYPE
    Lam64 = Lam.reshape(-1, 3, 3).astype(f64) + C.EPS_LIFT * jnp.eye(3, dtype=f64)
    pos = linalg.solve3x3(Lam64, th.reshape(-1, 3).astype(f64))
    eta_sum = jnp.sum(eta.reshape(-1, C.VMF_N_LOBES, 3).astype(f64), axis=1)
    kap = jnp.linalg.norm(eta_sum, axis=-1)
    dirs = eta_sum / (kap[:, None] + C.EPS_MASS)

    return AtlasView(
        positions=pos,
        directions=dirs,
        kappas=kap,
        weights=wv.reshape(-1).astype(f64),
        valid=vv.reshape(-1),
        primitive_ids=pv.reshape(-1),
        last_supported=ls.reshape(-1),
        tile_slot=jnp.repeat(tile_slots, V),
        slot=top_slots.reshape(-1),
        lidar_frac=(lm / (cm + lm + C.EPS_MASS)).reshape(-1).astype(f64),
    )


# ---------------------------------------------------------------------------
# Map evidence closure for the hypothesis step (steps 7-8)
# ---------------------------------------------------------------------------


class MapExtras(NamedTuple):
    """Per-hypothesis map-branch products needed by the shared map update."""

    batch: MeasurementBatch
    responsibilities: jnp.ndarray  # (N, K)
    cand_pool: jnp.ndarray  # (N, K) int32 pool rows
    row_masses: jnp.ndarray  # (N,)
    ot_transport_mass: jnp.ndarray
    ot_marginal_defect_a: jnp.ndarray
    z_map_pose: jnp.ndarray  # (6,) world pose the factor is linearized at
    # LiDAR translation residuals at the final linearization — the third
    # measurement-noise IW block's sufficient statistics (reference
    # measurement_noise_iw_jax.py:104-131 via pipeline.py:550-566)
    lidar_residuals: jnp.ndarray  # (N, K, 3) map - transformed surfel, world
    lidar_resid_w: jnp.ndarray  # (N, K) responsibility weights (surfel rows)


def build_measurement_inputs(
    deskewed_points, point_stamps, deskewed_weights, batch_in,
    atlas_view: AtlasView, z_center, cfg: PipelineConfig, sensor_var=None,
):
    """Surfel extraction + unified measurement batch + distance shortlist.

    Factored out of the map-evidence closure so scan_step can run it ONCE per
    scan and share the result across the vmapped hypotheses
    (cfg.map_share_extraction): extraction and the (N, P) shortlist selection
    are the map branch's dominant cost and depend on the hypothesis only
    through sub-voxel deskew differences; `z_center` is the pose the
    world-frame shortlist is taken at (per-hypothesis z_lin in the unshared
    path, hypothesis 0's predicted pose in the shared path —
    shortlist_margin_m covers the difference).

    Camera rows are dropped AT COMPILE TIME when cfg.with_camera is False:
    the batch then has n_surfel rows instead of n_feat + n_surfel, removing a
    dead third of every (N, ...)-shaped association/fuse tensor. (The
    reference always carries both slices, measurement_batch.py:69-157; with
    identical validity masking the zero-row batch is numerically identical.)
    """
    from gcslam_tpu.ops import association as assoc_mod

    surfels, surf_cert = extract_surfels(
        deskewed_points, point_stamps, deskewed_weights,
        cfg.n_surfel, cfg.surfel_voxel_size_m, cfg.surfel_min_points_per_voxel,
        sensor_var=sensor_var,
    )
    if cfg.with_camera:
        cam = (batch_in.cam_Lambdas, batch_in.cam_thetas, batch_in.cam_etas,
               batch_in.cam_weights, batch_in.cam_colors, batch_in.cam_valid)
    else:
        cam = (batch_in.cam_Lambdas[:0], batch_in.cam_thetas[:0],
               batch_in.cam_etas[:0], batch_in.cam_weights[:0],
               batch_in.cam_colors[:0], batch_in.cam_valid[:0])
    mbatch = from_camera_and_surfels(
        *cam, batch_in.t_scan,
        surfels.positions, surfels.Lambdas, surfels.normals, surfels.kappas,
        surfels.weights, surfels.timestamps, surfels.valid,
    )
    if cfg.k_shortlist > 0:
        R_sl = se3.so3_exp(z_center[3:6])
        mpos_w = mean_positions(mbatch, cfg.eps_lift) @ R_sl.T + z_center[None, :3]
        sl_idx = assoc_mod.shortlist_candidates(mpos_w, mbatch.valid, atlas_view, cfg)
        # one-shot gather of every round-invariant candidate attribute —
        # the GN rounds then run gather-free (association.CandidateSet)
        shortlist = assoc_mod.gather_candidates(atlas_view, sl_idx)
    else:
        shortlist = None
    return mbatch, shortlist, surf_cert


def make_map_evidence_fn(atlas_view: AtlasView, cfg: PipelineConfig, sensor_var=None,
                         shared=None):
    """Returns the map-branch closure used inside the vmapped hypothesis step.
    The view is shared (extracted once per scan); per-hypothesis deskewed
    points produce per-hypothesis surfels/associations, unless `shared`
    carries a precomputed (mbatch, shortlist, surf_cert) from
    build_measurement_inputs (cfg.map_share_extraction) — then the closure
    ignores the per-hypothesis points and only the GN rounds stay
    per-hypothesis.

    `sensor_var` is the adapted LiDAR sensor noise variance (tr(Sigma_l)/3
    from the measurement-noise IW block, reference pipeline.py:550-566) fed
    into the surfel covariance floor; None keeps the datasheet constant."""

    def map_evidence(deskewed_points, deskewed_weights, batch_in, z_lin_pose, belief_pred):
        if shared is not None:
            mbatch, shortlist, surf_cert = shared
            surf_cert = surf_cert._replace(
                triggers=surf_cert.triggers
                | jnp.uint64(TRIGGERS["hyp_shared_extraction"])
            )
        else:
            mbatch, shortlist, surf_cert = build_measurement_inputs(
                deskewed_points, batch_in.point_stamps, deskewed_weights,
                batch_in, atlas_view, z_lin_pose, cfg, sensor_var,
            )
        return map_gn_evidence(
            mbatch, shortlist, surf_cert, atlas_view,
            batch_in.scan_seq, z_lin_pose, cfg,
        )

    return map_evidence


def map_gn_evidence(mbatch, shortlist, surf_cert, atlas_view: AtlasView,
                    scan_seq, z_start, cfg: PipelineConfig):
    """Gauss-Newton rounds with COARSE-TO-FINE annealing: early rounds use
    a widened association kernel + robust scale (big capture basin —
    also what re-anchors revisits after drift), the FINAL round uses the
    configured tight values so the returned factor carries no
    soft-matching shrinkage bias. Iterating at a single tight scale is
    unstable (the re-association confirms the previous round's biased
    step with full authority), and a single wide round is biased — the
    anneal is what makes the iteration both wide-basin and unbiased.
    Rolled as ONE lax.scan over a static anneal schedule: every round
    has identical structure (association + evidence + trust-region
    step, the step zeroed on the final round), so XLA compiles the
    round body ONCE instead of n_rounds statically-unrolled copies
    (unrolling multiplied the compile time). The RETURNED factor is the final round's,
    linearized at the final z; scan_step shifts it into chart
    coordinates using that same z (returned in MapExtras).

    Callable per hypothesis (z_start = that hypothesis' z_lin) or ONCE per
    scan from the predicted pose (cfg.map_gn_shared) — the anneal's capture
    basin is what makes the predicted-pose start equivalent."""
    import dataclasses as _dc

    from gcslam_tpu.ops import association as assoc_mod
    from gcslam_tpu.ops import evidence_pose

    n_rounds = max(1, cfg.map_icp_iters)
    anneals = jnp.asarray(
        [cfg.map_icp_coarse_factor ** (n_rounds - 1 - it) for it in range(n_rounds)],
        dtype=BELIEF_DTYPE,
    )
    do_step = jnp.asarray(
        [1.0 if it + 1 < n_rounds else 0.0 for it in range(n_rounds)],
        dtype=BELIEF_DTYPE,
    )

    def _round_outputs(z, anneal):
        cfg_r = _dc.replace(
            cfg,
            ot_epsilon=cfg.ot_epsilon * anneal,
            pose_cauchy_r0_m=cfg.pose_cauchy_r0_m * jnp.sqrt(anneal),
        )
        assoc, assoc_cert = assoc_mod.associate_primitives_ot(
            mbatch, atlas_view, scan_seq, cfg_r, z,
            shortlist=shortlist,
        )
        L_lidar, h_lidar, vis_cert = evidence_pose.primitive_pose_evidence(
            assoc, mbatch, atlas_view, z, cfg_r, cands=shortlist
        )
        return (z, L_lidar, h_lidar, assoc, assoc_cert, vis_cert), cfg_r

    def gn_round(carry, xs):
        z, _prev = carry
        anneal, step_on = xs
        outs, cfg_r = _round_outputs(z, anneal)
        _, L_lidar, h_lidar, _, _, _ = outs
        L6 = L_lidar[0:6, 0:6] + cfg.eps_lift * jnp.eye(6, dtype=L_lidar.dtype)
        delta, _ = linalg.spd_solve_lifted(L6, h_lidar[0:6], cfg.eps_lift)
        # Trust region: the quadratic model is only valid inside this
        # round's association kernel. The final round takes no step
        # (step_on=0) — its factor is returned at its own linearization.
        step_cap = 2.0 * jnp.sqrt(cfg_r.ot_epsilon)
        nrm = jnp.linalg.norm(delta)
        delta = delta * (step_on * jnp.minimum(1.0, step_cap / (nrm + 1e-12)))
        z_next = se3.se3_compose(z, se3.se3_exp(delta))
        # last round's outputs ride the CARRY (only ys would force XLA to
        # stack n_rounds copies of the association tensors in HBM)
        return (z_next, outs), None

    out_shapes = jax.eval_shape(lambda z: _round_outputs(z, anneals[0])[0],
                                z_start)
    outs0 = jax.tree_util.tree_map(
        lambda sh: jnp.zeros(sh.shape, sh.dtype), out_shapes
    )
    (_, last), _ = jax.lax.scan(
        gn_round, (z_start, outs0), (anneals, do_step)
    )
    z, L_lidar, h_lidar, assoc, assoc_cert, vis_cert = last

    # LiDAR translation residual suffstats at the FINAL linearization:
    # r_ik = map_k - (R z) p_i - t z over surfel rows, weighted by the
    # (validity-masked) responsibilities. These feed the third
    # measurement-noise IW block (scan_step step 14).
    R_z = se3.so3_exp(z[3:6])
    meas_w = mean_positions(mbatch, cfg.eps_lift) @ R_z.T + z[None, :3]
    map_pos = atlas_view.positions[assoc.cand_pool]  # (N, K, 3)
    pair_ok = (
        mbatch.valid[:, None]
        & atlas_view.valid[assoc.cand_pool]
        & (mbatch.sources == 1)[:, None]
    )
    # NaN-safe: invalid atlas rows / an empty-view GN pose carry NaN
    # positions, and 0-weight x NaN = NaN would poison the IW einsum
    # downstream (measurement_iw_apply) even though the pair is masked.
    resid = jnp.where(pair_ok[:, :, None], map_pos - meas_w[:, None, :], 0.0)
    resid = jnp.where(jnp.isfinite(resid), resid, 0.0)
    resid_w = assoc.responsibilities * pair_ok.astype(resid.dtype)

    extras = MapExtras(
        batch=mbatch,
        responsibilities=assoc.responsibilities,
        cand_pool=assoc.cand_pool,
        row_masses=assoc.row_masses,
        ot_transport_mass=assoc.transport_mass,
        ot_marginal_defect_a=assoc.marginal_defect_a,
        z_map_pose=z,
        lidar_residuals=resid,
        lidar_resid_w=resid_w,
    )
    return L_lidar, h_lidar, [surf_cert, assoc_cert, vis_cert], extras


# ---------------------------------------------------------------------------
# Map update (step 15: fuse / insert / cull / forget / merge) — hypothesis 0
# ---------------------------------------------------------------------------


def _transform_to_world(Lam_b, th_b, eta_b, R, t, eps_lift):
    """Gaussian info form + vMF lobes, body -> world at pose (R, t).
    (reference pipeline.py:1248-1256)."""
    Lam_w = jnp.einsum("ij,njk,lk->nil", R, Lam_b, R)
    mu_b = linalg.solve3x3(Lam_b, th_b, eps=eps_lift)
    mu_w = mu_b @ R.T + t[None, :]
    th_w = jnp.einsum("nij,nj->ni", Lam_w, mu_w)
    eta_w = jnp.einsum("ij,nbj->nbi", R, eta_b)
    return Lam_w, th_w, eta_w, mu_w


class _Slab(NamedTuple):
    """The (A, M, ...) active-stencil slab of every per-slot atlas channel.

    MAP-STAGE COLLAPSE (round 5): fuse/insert/cull/merge each used to
    gather their own slab from the (T, M) atlas and scatter it straight
    back — 4 gather+scatter rounds of ~15 channels, which the optimized
    HLO showed as ~9 copies of the (7, 2048, 3, 3) Lambda slab alone
    (~27 MB of copies per scan, tools/hlo_census). map_update_step now
    gathers ONCE, chains the four stages slab-to-slab (pure elementwise /
    in-slab scatters), and scatters ONCE."""

    Lambdas: jnp.ndarray  # (A, M, 3, 3)
    thetas: jnp.ndarray  # (A, M, 3)
    etas: jnp.ndarray  # (A, M, B, 3)
    weights: jnp.ndarray  # (A, M)
    valid: jnp.ndarray  # (A, M) bool
    timestamps: jnp.ndarray  # (A, M)
    created: jnp.ndarray  # (A, M)
    last_supported: jnp.ndarray  # (A, M) int32
    last_update: jnp.ndarray  # (A, M) int32
    primitive_ids: jnp.ndarray  # (A, M) int32
    cam_mass: jnp.ndarray  # (A, M)
    lidar_mass: jnp.ndarray  # (A, M)
    rgb_accum: jnp.ndarray  # (A, M, 3)
    rgb_denom: jnp.ndarray  # (A, M)
    rgb: jnp.ndarray  # (A, M, 3)


def _gather_slab(atlas: AtlasState, active_slots) -> _Slab:
    return _Slab(**{f: getattr(atlas, f)[active_slots] for f in _Slab._fields})


def _scatter_slab(atlas: AtlasState, active_slots, slab: _Slab) -> AtlasState:
    a = active_slots
    return atlas._replace(
        **{f: getattr(atlas, f).at[a].set(getattr(slab, f))
           for f in _Slab._fields}
    )


def _fuse(atlas: AtlasState, view: AtlasView, extras: MapExtras,
          Lam_w, th_w, eta_w, active_slots, scan_seq, timestamp, cfg: PipelineConfig):
    """Compatibility wrapper: gather slab -> _fuse_slab -> scatter."""
    slab = _gather_slab(atlas, active_slots)
    slab, fused_mass = _fuse_slab(
        slab, view, extras, Lam_w, th_w, eta_w, scan_seq, timestamp, cfg)
    return _scatter_slab(atlas, active_slots, slab), fused_mass


def _fuse_slab(slab: _Slab, view: AtlasView, extras: MapExtras,
               Lam_w, th_w, eta_w, scan_seq, timestamp, cfg: PipelineConfig):
    """PoE scatter-add fuse of all (meas, candidate) pairs in ONE pass
    (replaces the reference's Python block x tile loops, pipeline.py:1258-1327).

    SLAB LAYOUT: the accumulator and every read-modify-write run over the
    (S_active, M) slab of stencil tiles, not the full (T, M) atlas — the
    previous full-atlas accumulator + per-array adds/wheres were pure
    T*M-proportional memory traffic, most of the scan's cost at production
    atlas sizes. Pool row p sits at stencil position p // m_tile_view
    by construction (extract_view stitches tiles in active_slots order), so
    the pool -> slab mapping needs no table lookup."""
    S, M = slab.weights.shape
    V = cfg.m_tile_view
    N, K = extras.responsibilities.shape
    pool = extras.cand_pool.reshape(-1)  # (N*K,)
    resp = extras.responsibilities.reshape(-1).astype(MAPF)
    pair_valid = (extras.batch.valid[:, None] & view.valid[pool].reshape(N, K)).reshape(-1)
    resp = resp * pair_valid.astype(MAPF)

    stencil_pos = pool // V  # (N*K,) slab tile index
    slot = view.slot[pool]
    # invalid pairs target S*M: a POSITIVE out-of-bounds row, which
    # mode="drop" really drops. (A -1 sentinel WRAPS to the last atlas slot
    # under JAX scatter semantics even with mode="drop" — the zero payload
    # kept it harmless here, but the sentinel must still be OOB-positive.)
    flat = jnp.where(pair_valid, stencil_pos * M + slot, S * M)

    rep = lambda x: jnp.repeat(x, K, axis=0)
    Lam_m = rep(Lam_w).astype(MAPF)
    th_m = rep(th_w).astype(MAPF)
    eta_m = rep(eta_w).astype(MAPF)
    w_m = rep(extras.batch.weights).astype(MAPF)
    col_m = rep(extras.batch.colors).astype(MAPF)
    is_cam = rep((extras.batch.sources == 0)).astype(MAPF)
    is_lid = rep((extras.batch.sources == 1)).astype(MAPF)

    # ONE packed scatter-add for every fused channel: nine narrow scatters
    # sharing this index set would each walk the same update rows (nine
    # kernels, nine index passes) where one wide scatter of the
    # concatenated payload walks them once (channel widths: Lambda 9, theta 3, eta B*3, w 1, cam 1,
    # lidar 1, rgb_accum 3, [rgb_denom == cam], resp 1).
    NB = C.VMF_N_LOBES * 3
    rw = resp * w_m
    rwc = rw * is_cam
    payload = jnp.concatenate(
        [
            resp[:, None] * Lam_m.reshape(-1, 9),
            resp[:, None] * th_m,
            resp[:, None] * eta_m.reshape(-1, NB),
            rw[:, None],
            rwc[:, None],
            (rw * is_lid)[:, None],
            col_m * rwc[:, None],
            resp[:, None],
        ],
        axis=1,
    )  # (N*K, 17 + NB)
    acc = (
        jnp.zeros((S * M, payload.shape[1]), dtype=MAPF)
        .at[flat].add(payload, mode="drop")
    )

    def seg(o, w, shape):
        a = acc[:, o] if w == 1 else acc[:, o:o + w]
        return a.reshape(shape)

    # Pure-additive channels: scatter-ADD the slab increment into the S
    # active tile rows. Channels whose update depends on the OLD value
    # (timestamps/rgb/...) gather the S-row slab, combine, scatter-SET.
    cam_inc = seg(13 + NB, 1, (S, M))
    cam_slab = slab.cam_mass + cam_inc
    rgb_accum_slab = slab.rgb_accum + seg(15 + NB, 3, (S, M, 3))
    rgb_denom_slab = slab.rgb_denom + cam_inc
    resp_sum = seg(18 + NB, 1, (S, M))
    updated = resp_sum > 0.0
    seq32 = scan_seq.astype(jnp.int32)
    ls_slab = jnp.where(updated, seq32, slab.last_supported)
    lu_slab = jnp.where(updated, seq32, slab.last_update)
    ts_slab = jnp.where(
        updated, timestamp.astype(TIME_DTYPE), slab.timestamps
    )
    has_cam = cam_slab > 0.0
    rgb_est = jnp.clip(
        rgb_accum_slab / jnp.maximum(rgb_denom_slab[..., None], cfg.eps_mass), 0.0, 1.0
    )
    rgb_slab = jnp.where(has_cam[..., None], rgb_est, 0.5)

    fused_mass = jnp.sum(resp * w_m)
    slab = slab._replace(
        Lambdas=slab.Lambdas + seg(0, 9, (S, M, 3, 3)).astype(slab.Lambdas.dtype),
        thetas=slab.thetas + seg(9, 3, (S, M, 3)).astype(slab.thetas.dtype),
        etas=slab.etas + seg(12, NB, (S, M, C.VMF_N_LOBES, 3)).astype(slab.etas.dtype),
        weights=slab.weights + seg(12 + NB, 1, (S, M)).astype(slab.weights.dtype),
        timestamps=ts_slab,
        last_supported=ls_slab,
        last_update=lu_slab,
        cam_mass=cam_slab,
        lidar_mass=slab.lidar_mass + seg(14 + NB, 1, (S, M)).astype(slab.lidar_mass.dtype),
        rgb_accum=rgb_accum_slab,
        rgb_denom=rgb_denom_slab,
        rgb=rgb_slab,
    )
    return slab, fused_mass


def _insert(atlas: AtlasState, extras: MapExtras, mu_w, Lam_w, th_w, eta_w,
            active_slots, active_ids, scan_seq, timestamp, cfg: PipelineConfig):
    """Compatibility wrapper: gather slab -> _insert_slab -> scatter."""
    slab = _gather_slab(atlas, active_slots)
    slab, next_id, insert_mass, evicted_mass, events = _insert_slab(
        slab, atlas.next_global_id, extras, mu_w, Lam_w, th_w, eta_w,
        active_ids, scan_seq, timestamp, cfg)
    atlas = _scatter_slab(atlas, active_slots, slab)
    return atlas._replace(next_global_id=next_id), insert_mass, evicted_mass, events


def _insert_slab(slab: _Slab, next_global_id, extras: MapExtras, mu_w,
                 Lam_w, th_w, eta_w, active_ids, scan_seq, timestamp,
                 cfg: PipelineConfig):
    """Novelty-driven fixed-budget insert with lowest-retention eviction
    (reference pipeline.py:1329-1410 + primitive_map_insert_masked)."""
    A, M = slab.weights.shape
    Kin = cfg.k_insert_tile
    b = extras.batch

    a = b.valid.astype(BELIEF_DTYPE)
    a = a / jnp.maximum(jnp.sum(a), cfg.eps_mass)
    novelty = jnp.maximum(a - extras.row_masses, 0.0)
    score = novelty * b.weights - (1.0 - b.valid.astype(BELIEF_DTYPE)) * 1e6

    meas_tile_ids = tiling.tile_ids_from_xyz(mu_w, cfg.h_tile)  # (N,)

    # Per active tile: top-Kin in-tile proposals. The insert gate must sit
    # ABOVE the invalid-row penalty band (-1e6): with a > -1e20 gate, any
    # tile with fewer than Kin valid in-tile proposals filled the remainder
    # with INVALID rows — weight-0 ghost primitives (camera-slice zeros at
    # the origin tile) that saturated the insert budget every scan and, in
    # f32, carried non-finite positions into the atlas.
    in_tile = meas_tile_ids[None, :] == active_ids[:, None]  # (A, N)
    score_t = jnp.where(in_tile, score[None, :], -1e30)
    top_score, top_idx = jax.lax.top_k(score_t, Kin)  # (A, Kin)
    do_insert = top_score > 0.0  # in-tile & valid & positive novelty mass

    # Eviction targets: Kin lowest-retention slots per tile (invalid first).
    dt = jnp.maximum(0, scan_seq.astype(jnp.int32) - slab.last_supported)
    decay = jnp.exp(-cfg.recency_decay_lambda * dt.astype(MAPF))
    retention = slab.weights * decay
    # invalid slots rank FIRST for eviction via a large finite bonus.
    retention = jnp.where(slab.valid, retention, -jnp.inf)
    evict_rank = jnp.where(jnp.isfinite(retention), -retention, 1e30)
    _, evict_slots = jax.lax.top_k(evict_rank, Kin)  # (A, Kin) lowest retention

    # Gather proposal payloads.
    w_new = (novelty * b.weights)[...]
    gi = top_idx.reshape(-1)  # (A*Kin,)
    ins_valid = do_insert.reshape(-1)
    Lam_i = Lam_w[gi].astype(MAPF)
    th_i = th_w[gi].astype(MAPF)
    eta_i = eta_w[gi].astype(MAPF)
    w_i = (w_new[gi] * ins_valid).astype(MAPF)
    col_i = b.colors[gi].astype(MAPF)
    cam_i = (b.sources[gi] == 0).astype(MAPF)

    # Global ids via prefix sum over insert order.
    order_ids = (next_global_id + jnp.cumsum(ins_valid.astype(jnp.int32)) - 1).astype(jnp.int32)
    new_ids = jnp.where(ins_valid, order_ids, jnp.int32(-1))
    n_inserted = jnp.sum(ins_valid.astype(jnp.int32)).astype(jnp.int32)

    # SLAB target: active tile a's evictions land at slab row a*M + slot;
    # invalid rows point at A*M (positive OOB -> really dropped; the previous
    # -1 sentinel WRAPS to the last atlas slot even under mode="drop" and
    # clobbered it with a weight-0 ghost every scan).
    flat = jnp.where(
        ins_valid,
        jnp.repeat(jnp.arange(A, dtype=jnp.int32), Kin) * M + evict_slots.reshape(-1),
        A * M,
    )
    # Mass of evicted (still-valid) slots — a certified budgeting approximation.
    ret_gather = jnp.take_along_axis(
        jnp.where(jnp.isfinite(retention), retention, 0.0), evict_slots, axis=1
    ).reshape(-1)
    evicted_mass = jnp.sum(ret_gather * ins_valid.astype(MAPF))

    has_cam = cam_i * (w_i > 0)
    rgb_new = jnp.where((has_cam > 0)[:, None], jnp.clip(col_i, 0.0, 1.0), 0.5)

    # THREE packed scatters (f32 payload / f64 payload / written-mask) replace
    # 15 narrow scatter-sets sharing this index set — each scatter walks
    # the update rows again, so cost scales with scatter COUNT x rows.
    # Valid `flat` targets are unique (per-tile evict slots are distinct,
    # tiles disjoint); invalid rows target A*M — POSITIVE out-of-bounds,
    # really dropped (a -1 sentinel wraps to the last slot even under
    # mode="drop"; see the `flat` construction above). int32 channels ride
    # the f64 payload (exact for |v| < 2^53); the mask selects written rows.
    NB = C.VMF_N_LOBES * 3
    pay32 = jnp.concatenate(
        [
            Lam_i.reshape(-1, 9),
            th_i,
            eta_i.reshape(-1, NB),
            w_i[:, None],
            (w_i * cam_i)[:, None],
            (w_i * (1.0 - cam_i))[:, None],
            col_i * (w_i * cam_i)[:, None],
            rgb_new,
        ],
        axis=1,
    )  # (A*Kin, 18 + NB)
    pay64 = jnp.stack(
        [
            jnp.full(w_i.shape, timestamp, dtype=TIME_DTYPE),
            jnp.full(w_i.shape, timestamp, dtype=TIME_DTYPE),
            jnp.full(w_i.shape, scan_seq, dtype=TIME_DTYPE),
            new_ids.astype(TIME_DTYPE),
        ],
        axis=1,
    )  # (A*Kin, 4): timestamp, created, scan_seq (last_supported==last_update), id
    # Slab accumulators: (A*M, .) — the full-atlas (T*M, .) accumulators +
    # per-array where-passes here were the other half of that
    # T*M-proportional cost. Each channel gathers its S-row
    # slab, takes written rows from the payload, and scatter-SETs back.
    acc32 = (
        jnp.zeros((A * M, pay32.shape[1]), dtype=MAPF).at[flat].set(pay32, mode="drop")
    )
    acc64 = (
        jnp.zeros((A * M, 4), dtype=TIME_DTYPE).at[flat].set(pay64, mode="drop")
    )
    written = (
        jnp.zeros((A * M,), dtype=bool).at[flat].set(True, mode="drop").reshape(A, M)
    )

    def pick(old, o, w):
        old_flat = old.reshape((A * M,) + old.shape[2:])
        new = (acc32[:, o] if w == 1 else acc32[:, o:o + w]).reshape(old_flat.shape)
        m = written.reshape((A * M,) + (1,) * (old.ndim - 2))
        return jnp.where(m, new.astype(old.dtype), old_flat).reshape(old.shape)

    def pick64(old, col, astype=None):
        new = acc64[:, col].reshape(A, M)
        if astype is not None:
            new = new.astype(astype)
        return jnp.where(written, new.astype(old.dtype), old)

    slab = slab._replace(
        Lambdas=pick(slab.Lambdas, 0, 9),
        thetas=pick(slab.thetas, 9, 3),
        etas=pick(slab.etas, 12, NB),
        weights=pick(slab.weights, 12 + NB, 1),
        timestamps=pick64(slab.timestamps, 0),
        created=pick64(slab.created, 1),
        last_supported=pick64(slab.last_supported, 2, jnp.int32),
        last_update=pick64(slab.last_update, 2, jnp.int32),
        primitive_ids=pick64(slab.primitive_ids, 3, jnp.int32),
        valid=slab.valid | written,
        cam_mass=pick(slab.cam_mass, 13 + NB, 1),
        lidar_mass=pick(slab.lidar_mass, 14 + NB, 1),
        rgb_accum=pick(slab.rgb_accum, 15 + NB, 3),
        rgb_denom=pick(slab.rgb_denom, 13 + NB, 1),
        rgb=pick(slab.rgb, 18 + NB, 3),
    )
    next_global_id = (next_global_id + n_inserted).astype(jnp.int32)
    insert_mass = jnp.sum(w_i)
    # Per-insertion event payloads (reference pipeline.py:1393-1410 logs
    # tile_id/mu_world/weight per inserted primitive for post-run replay):
    # fixed-shape (A*Kin,) arrays, id=-1 marks no-insert rows.
    events = dict(
        ins_ids=new_ids,  # (A*Kin,) int32, -1 invalid
        ins_tiles=jnp.repeat(active_ids, Kin),  # (A*Kin,) int64
        ins_mu=mu_w[gi].astype(MAPF) * ins_valid[:, None].astype(MAPF),
        ins_w=w_i,
    )
    return slab, next_global_id, insert_mass, evicted_mass, events


# Precision floor below which a primitive is informationless: repeated
# recency decay drives stale primitives' Lambda toward f32 underflow
# (observed ~1e-24 after ~100 unsupported scans), where the export-side
# solve for mu overflows and the primitive is pure ghost mass. Such rows
# are culled like zero-weight rows.
LAMBDA_CULL_FLOOR = 1e-12


def _cull_forget(atlas: AtlasState, active_slots, cfg: PipelineConfig):
    """Compatibility wrapper: gather slab -> _cull_forget_slab -> scatter."""
    slab = _gather_slab(atlas, active_slots)
    slab, mass_dropped, n_culled = _cull_forget_slab(slab, cfg)
    return _scatter_slab(atlas, active_slots, slab), mass_dropped, n_culled


def _cull_forget_slab(slab: _Slab, cfg: PipelineConfig):
    """Cull below-threshold weights + precision-collapsed primitives +
    continuous forgetting, active tiles only (reference
    primitive_map.py:1157-1386; the Lambda floor is an addition — the
    reference's unbounded dict atlas never decays precision to underflow)."""
    w_act = slab.weights
    v_act = slab.valid
    lam_max = jnp.max(
        jnp.abs(jnp.diagonal(slab.Lambdas, axis1=-2, axis2=-1)),
        axis=-1,
    )  # (S, M)
    below = v_act & (
        (w_act < cfg.cull_weight_threshold) | (lam_max < LAMBDA_CULL_FLOOR)
    )
    mass_dropped = jnp.sum(w_act * below.astype(MAPF))
    n_culled = jnp.sum(below.astype(jnp.int32))
    slab = slab._replace(
        valid=v_act & ~below,
        weights=w_act * cfg.forgetting_factor,
    )
    return slab, mass_dropped, n_culled


V_MERGE = 128  # merge-reduce candidate window per tile (fixed budget)
KC_MERGE = 64  # pair shortlist per tile: nearest-by-mu pairs get the full
# Bhattacharyya treatment. Exact for every merge-ELIGIBLE pair as long as
# fewer than KC_MERGE pairs are closer in mu: eligibility requires
# dist = quad + logt < threshold with logt >= 0 (det(avg Sig) >= sqrt of the
# det product for PSD), so quad = 0.125 dmu' Sinv dmu < threshold already
# forces eligible pairs mu-near; the V*V/2 full pairwise tile (16k 3x3
# inverses per tile per scan) only ever scored pairs the threshold could
# never accept.


def _merge_reduce(atlas: AtlasState, active_slots, cfg: PipelineConfig):
    """Bhattacharyya merge-reduce, <= k_merge_pairs per active tile.

    Fixed-budget redesign of reference primitive_map.py:1501-1900: per tile,
    only the top V_MERGE-by-weight slots are merge candidates, and only the
    KC_MERGE nearest-by-mu pairs are scored (declared budgeting
    approximations; the reference caps at tile size 2048 and merges the 4
    closest pairs — which essentially always live among high-mass, mu-near
    primitives). Greedy disjoint pair selection = Kp iterations of masked
    argmin over the pair shortlist. Merged moments are weight-matched
    Gaussian moments; vMF lobes and provenance add; the losing slot is
    invalidated.
    """
    slab = _gather_slab(atlas, active_slots)
    slab, n_merged = _merge_reduce_slab(slab, cfg)
    if slab is None:  # merge disabled: no-op without a scatter round-trip
        return atlas, n_merged
    return _scatter_slab(atlas, active_slots, slab), n_merged


def _merge_reduce_slab(slab: _Slab, cfg: PipelineConfig):
    Kp = cfg.k_merge_pairs_tile
    if Kp <= 0:  # merge disabled — a zero budget must be a no-op, not a crash
        return None, jnp.zeros((), dtype=jnp.int32)
    A, Mfull = slab.weights.shape
    f64 = BELIEF_DTYPE
    V = min(V_MERGE, Mfull)
    KC = min(KC_MERGE, (V * (V - 1)) // 2)

    # SLAB LAYOUT (same rationale as _fuse/_insert): all reads and the
    # merge apply operate on the (A, M) stencil slab; map_update_step owns
    # the single gather/scatter round.
    w_slab = slab.weights  # (A, M)
    v_slab = slab.valid
    Lam_slab = slab.Lambdas
    th_slab = slab.thetas
    eta_slab = slab.etas
    cam_slab = slab.cam_mass
    lid_slab = slab.lidar_mass
    rga_slab = slab.rgb_accum
    rgd_slab = slab.rgb_denom
    rgb_slab = slab.rgb
    ls_slab = slab.last_supported
    score = jnp.where(v_slab, w_slab, -jnp.inf)
    _, cand = jax.lax.top_k(score, V)  # (A, V)

    def per_tile(Lam_t, th_t, w_t, v_t, cand_slots):
        Lam = jnp.take(Lam_t, cand_slots, axis=0).astype(f64)
        th = jnp.take(th_t, cand_slots, axis=0).astype(f64)
        w = jnp.take(w_t, cand_slots).astype(f64)
        v = jnp.take(v_t, cand_slots)
        Lam_r = Lam + C.EPS_LIFT * jnp.eye(3, dtype=f64)
        Sig = linalg.inv3x3(Lam_r)
        mu = jnp.einsum("vij,vj->vi", Sig, th)
        det = linalg.det3x3(Sig)

        # Pair shortlist by mu distance (cheap (V, V) scalar tile), then the
        # full Bhattacharyya only on the KC shortlisted pairs.
        d2 = jnp.sum((mu[:, None, :] - mu[None, :, :]) ** 2, axis=-1)
        pair_ok = v[:, None] & v[None, :]
        iu = jnp.triu_indices(V, k=1)
        upper_ok = jnp.zeros((V, V), dtype=bool).at[iu].set(True)
        d2 = jnp.where(pair_ok & upper_ok, d2, jnp.inf)
        # blocked exact top-k over the V*V (=16k) pair scores: identical
        # in value and tie-break to a flat top_k
        # (association._topk_blocked docstring)
        from gcslam_tpu.ops.association import _topk_blocked

        _, pflat = _topk_blocked(-d2.reshape(-1), KC)  # (KC,) flat pair ids
        pi = (pflat // V).astype(jnp.int32)
        pj = (pflat % V).astype(jnp.int32)

        S = 0.5 * (Sig[pi] + Sig[pj])  # (KC, 3, 3)
        detS = linalg.det3x3(S)
        Sinv = linalg.inv3x3(S, eps=C.EPS_LIFT)
        dmu = mu[pi] - mu[pj]
        quad = 0.125 * jnp.einsum("ki,kij,kj->k", dmu, Sinv, dmu)
        logt = 0.5 * jnp.log(detS / jnp.sqrt(det[pi] * det[pj] + 1e-24))
        dist = quad + logt
        dist = jnp.where(v[pi] & v[pj] & jnp.isfinite(d2.reshape(-1)[pflat]), dist, jnp.inf)
        return dist, pi, pj, mu, Sig, w, v

    dists, pis, pjs, mus, Sigs, ws, vs = jax.vmap(per_tile)(
        Lam_slab, th_slab, w_slab, v_slab, cand
    )

    # Greedy disjoint selection: Kp iterations of masked argmin over the
    # (KC,) pair shortlist per tile (pairs sharing a slot with a selected
    # pair are knocked out).
    def select(dist, pi, pj):
        def body(k, carry):
            dist_c, sel_i, sel_j, n_sel = carry
            p = jnp.argmin(dist_c)
            i = pi[p]
            j = pj[p]
            ok = dist_c[p] < cfg.merge_threshold
            sel_i = sel_i.at[k].set(jnp.where(ok, i, -1))
            sel_j = sel_j.at[k].set(jnp.where(ok, j, -1))
            conflict = (pi == i) | (pi == j) | (pj == i) | (pj == j)
            dist_c = jnp.where(ok & conflict, jnp.inf, dist_c)
            return dist_c, sel_i, sel_j, n_sel + ok.astype(jnp.int32)

        sel_i0 = jnp.full((Kp,), -1, dtype=jnp.int32)
        sel_j0 = jnp.full((Kp,), -1, dtype=jnp.int32)
        _, sel_i, sel_j, n_sel = jax.lax.fori_loop(
            0, Kp, body, (dist, sel_i0, sel_j0, 0), unroll=4
        )
        return sel_i, sel_j, n_sel

    sel_i, sel_j, n_sel = jax.vmap(select)(dists, pis, pjs)  # (A, Kp)

    # Apply merges: moment-matched Gaussian, summed vMF/provenance.
    # Pairs are greedily DISJOINT within a tile and tiles occupy distinct
    # slots, so every write below is disjoint — the whole apply is a handful
    # of batched drop-mode scatters. (This replaced a fori_loop of A*Kp
    # lax.conds over full-atlas updates that dominated compile time.)
    M = Mfull
    ok = sel_i >= 0  # (A, Kp)
    ii = jnp.maximum(sel_i, 0)
    jj = jnp.maximum(sel_j, 0)

    def takek(x, idx):  # x (A, V, ...) gathered at idx (A, Kp) -> (A, Kp, ...)
        return jnp.take_along_axis(
            x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), axis=1
        )

    w1 = takek(ws, ii)
    w2 = takek(ws, jj)
    wsum = w1 + w2
    wsafe = jnp.maximum(wsum, C.EPS_MASS)
    mu1, mu2 = takek(mus, ii), takek(mus, jj)
    S1, S2 = takek(Sigs, ii), takek(Sigs, jj)
    mu_m = (w1[..., None] * mu1 + w2[..., None] * mu2) / wsafe[..., None]
    d1 = mu1 - mu_m
    d2 = mu2 - mu_m
    outer = lambda d: jnp.einsum("aki,akj->akij", d, d)
    S_m = (
        w1[..., None, None] * (S1 + outer(d1)) + w2[..., None, None] * (S2 + outer(d2))
    ) / wsafe[..., None, None]
    S_m = S_m + C.EPS_PSD * jnp.eye(3, dtype=S_m.dtype)
    Lam_m = linalg.inv3x3(S_m)
    th_m = jnp.einsum("akij,akj->aki", Lam_m, mu_m)

    ci = jnp.take_along_axis(cand, ii, axis=1)
    cj = jnp.take_along_axis(cand, jj, axis=1)

    def g2(x, idx):  # (A, M, ...) gathered at (A, Kp) slot indices
        return jnp.take_along_axis(
            x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), axis=1
        )

    eta_i = g2(eta_slab, ci).astype(BELIEF_DTYPE)
    eta_j = g2(eta_slab, cj).astype(BELIEF_DTYPE)
    eta_m = (w1[..., None, None] * eta_i + w2[..., None, None] * eta_j) / wsafe[..., None, None]

    # masked SLAB scatter targets: not-ok pairs write row A*M (positive OOB
    # -> really dropped); winner rows (fi) and loser rows (fj) are disjoint
    # within a scatter (greedy-disjoint pairs, tiles at distinct slab rows).
    af = jnp.arange(A, dtype=jnp.int32)[:, None]
    fi = jnp.where(ok, af * M + ci, A * M).reshape(-1)
    fj = jnp.where(ok, af * M + cj, A * M).reshape(-1)

    def supd(slab, fidx, val):
        flat = slab.reshape((A * M,) + slab.shape[2:])
        v = val.reshape((-1,) + val.shape[2:]).astype(slab.dtype)
        return flat.at[fidx].set(v, mode="drop").reshape(slab.shape)

    cam_i, cam_j = g2(cam_slab, ci), g2(cam_slab, cj)
    lid_i, lid_j = g2(lid_slab, ci), g2(lid_slab, cj)
    rga_i, rga_j = g2(rga_slab, ci), g2(rga_slab, cj)
    rgd_i, rgd_j = g2(rgd_slab, ci), g2(rgd_slab, cj)
    ls_i, ls_j = g2(ls_slab, ci), g2(ls_slab, cj)
    zero_k = jnp.zeros_like(w1)

    slab = slab._replace(
        Lambdas=supd(Lam_slab, fi, Lam_m),
        thetas=supd(th_slab, fi, th_m),
        etas=supd(eta_slab, fi, eta_m),
        weights=supd(supd(w_slab, fi, wsum), fj, zero_k),
        valid=supd(v_slab, fj, jnp.zeros_like(ok)),
        cam_mass=supd(supd(cam_slab, fi, cam_i + cam_j), fj, zero_k),
        lidar_mass=supd(supd(lid_slab, fi, lid_i + lid_j), fj, zero_k),
        rgb_accum=supd(rga_slab, fi, rga_i + rga_j),
        rgb_denom=supd(rgd_slab, fi, rgd_i + rgd_j),
        # Refresh the canonical color for winner rows NOW: the old full-atlas
        # rgb recompute in _fuse healed merged colors the next scan, but the
        # slab refactor only touches active tiles — a tile merged on its last
        # active scan would export a stale pre-merge color.
        rgb=supd(
            rgb_slab,
            fi,
            jnp.where(
                ((cam_i + cam_j) > 0)[..., None],
                jnp.clip(
                    (rga_i + rga_j)
                    / jnp.maximum((rgd_i + rgd_j)[..., None], C.EPS_MASS),
                    0.0,
                    1.0,
                ),
                0.5,
            ),
        ),
        last_supported=supd(ls_slab, fi, jnp.maximum(ls_i, ls_j)),
    )
    return slab, jnp.sum(n_sel).astype(jnp.int32)


def map_update_step(
    atlas: AtlasState,
    view: AtlasView,
    extras: MapExtras,
    z_t_pose: jnp.ndarray,
    active_slots: jnp.ndarray,
    active_ids: jnp.ndarray,
    scan_seq: jnp.ndarray,
    timestamp: jnp.ndarray,
    cfg: PipelineConfig,
):
    """Full step-15 map update at z_t (post-recompose pose of hypothesis 0)."""
    R_t = se3.so3_exp(z_t_pose[3:6])
    t_t = z_t_pose[:3]
    b = extras.batch
    Lam_w, th_w, eta_w, mu_w = _transform_to_world(
        b.Lambdas, b.thetas, b.etas, R_t, t_t, cfg.eps_lift
    )

    # MAP-STAGE COLLAPSE: one slab gather, the four stages chained
    # slab-to-slab, one scatter — instead of 4 gather+scatter rounds of
    # ~15 (A, M, ...) channels each (the optimized HLO showed ~9 copies of
    # the Lambda slab alone before this; tools/hlo_census).
    slab = _gather_slab(atlas, active_slots)
    slab, fused_mass = _fuse_slab(
        slab, view, extras, Lam_w, th_w, eta_w, scan_seq, timestamp, cfg
    )
    slab, next_id, insert_mass, evicted_mass, ins_events = _insert_slab(
        slab, atlas.next_global_id, extras, mu_w, Lam_w, th_w, eta_w,
        active_ids, scan_seq, timestamp, cfg
    )
    slab, cull_mass, n_culled = _cull_forget_slab(slab, cfg)
    merge_every = getattr(cfg, "merge_every", 1)
    if cfg.k_merge_pairs_tile <= 0:
        n_merged = jnp.zeros((), dtype=jnp.int32)
    elif merge_every > 1:
        # Merge cadence: merge-reduce is the heaviest map stage, and its
        # effect is maintenance, not estimation — pairs that become
        # eligible stay eligible. Running it every K-th scan amortizes the
        # cost ~K-fold; the off-scan branch is an identity cond. Declared
        # budgeting approximation (merge_reduce trigger fires on merge
        # scans as before).
        slab, n_merged = jax.lax.cond(
            scan_seq.astype(jnp.int32) % merge_every == merge_every - 1,
            lambda s: _merge_reduce_slab(s, cfg),
            lambda s: (s, jnp.zeros((), dtype=jnp.int32)),
            slab,
        )
    else:
        slab, n_merged = _merge_reduce_slab(slab, cfg)
    atlas = _scatter_slab(atlas, active_slots, slab)
    atlas = atlas._replace(next_global_id=next_id)

    tape = dict(
        fused_mass=fused_mass.astype(BELIEF_DTYPE),
        insert_mass=insert_mass.astype(BELIEF_DTYPE),
        evicted_mass=(evicted_mass + cull_mass).astype(BELIEF_DTYPE),
        n_culled=n_culled.astype(BELIEF_DTYPE),
        n_merged=n_merged.astype(BELIEF_DTYPE),
        valid_total=jnp.sum(atlas.valid.astype(BELIEF_DTYPE)),
        ot_transport_mass=extras.ot_transport_mass.astype(BELIEF_DTYPE),
        ot_marginal_defect_a=extras.ot_marginal_defect_a.astype(BELIEF_DTYPE),
        **ins_events,
    )
    return atlas, tape
