"""Atlas / surfel / association unit tests (models reference
test_lidar_surfel_extraction_mahex3d.py, test_primitive_map_merge_reduce.py)."""

import numpy as np

import jax
from gcslam_tpu.utils.xla import jnp
from gcslam_tpu import constants as C
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import atlas as A
from gcslam_tpu.ops.surfels import extract_surfels
from gcslam_tpu.ops import tiling

RNG = np.random.default_rng(5)
CFG = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64)


def test_surfel_extraction_plane():
    """Points on a plane -> surfels with the plane's normal and high kappa."""
    n = 1024
    pts = np.zeros((n, 3))
    pts[:, 0] = RNG.uniform(-0.5, 0.5, n)
    pts[:, 1] = RNG.uniform(-0.5, 0.5, n)
    pts[:, 2] = 0.002 * RNG.normal(size=n)  # near z=0 plane
    s, cert = extract_surfels(
        jnp.asarray(pts, dtype=jnp.float32), jnp.zeros(n), jnp.ones(n),
        n_surfel=64, voxel_size_m=0.25, min_points=3,
    )
    nv = int(s.n_valid)
    assert nv >= 4
    normals = np.asarray(s.normals)[:nv]
    # normals should be +-z (sign convention: z >= 0); cells with barely
    # min_points points can have noisy fits, so check the bulk.
    assert np.quantile(np.abs(normals[:, 2]), 0.1) > 0.9
    assert np.median(np.asarray(s.kappas)[:nv]) > 1.0
    # positions on the plane
    assert np.abs(np.asarray(s.positions)[:nv, 2]).max() < 0.05


def test_surfel_zero_weight_points_ignored():
    n = 256
    pts = RNG.normal(size=(n, 3)).astype(np.float32)
    s, _ = extract_surfels(jnp.asarray(pts), jnp.zeros(n), jnp.zeros(n), n_surfel=32)
    assert int(s.n_valid) == 0


def test_tile_ids_deterministic_and_local():
    xyz = jnp.asarray([[0.5, 0.5, 0.0], [0.6, 0.4, 0.1], [10.0, 10.0, 0.0]])
    ids = tiling.tile_ids_from_xyz(xyz, 2.0)
    assert int(ids[0]) == int(ids[1])  # same tile
    assert int(ids[0]) != int(ids[2])
    # stencil contains the center tile and has the declared size
    st = tiling.stencil_tile_ids(xyz[0], 1, 0, 2.0)
    assert st.shape[0] == C.N_STENCIL_TILES
    assert int(ids[0]) in [int(t) for t in np.asarray(st)]


def test_atlas_allocate_lookup_roundtrip():
    atlas = A.empty_atlas(CFG)
    q = jnp.asarray([111, 222, 333], dtype=jnp.int64)
    atlas, slots = A.allocate_tiles(atlas, q, jnp.asarray(1, dtype=jnp.int32))
    slots2, found = A.lookup_tiles(atlas, q)
    assert np.all(np.asarray(found))
    np.testing.assert_array_equal(np.asarray(slots), np.asarray(slots2))
    # re-allocating the same ids is idempotent
    atlas2, slots3 = A.allocate_tiles(atlas, q, jnp.asarray(2, dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(slots), np.asarray(slots3))


def test_atlas_lru_eviction():
    atlas = A.empty_atlas(CFG)  # 8 tiles
    for seq in range(3):
        ids = jnp.asarray(np.arange(seq * 4, seq * 4 + 4), dtype=jnp.int64)
        atlas, _ = A.allocate_tiles(atlas, ids, jnp.asarray(seq, dtype=jnp.int32))
    # 12 ids into 8 slots: the oldest 4 must have been evicted
    _, found_old = A.lookup_tiles(atlas, jnp.asarray([0, 1, 2, 3], dtype=jnp.int64))
    _, found_new = A.lookup_tiles(atlas, jnp.asarray([8, 9, 10, 11], dtype=jnp.int64))
    assert not np.any(np.asarray(found_old))
    assert np.all(np.asarray(found_new))


def test_view_of_empty_atlas_is_invalid():
    atlas = A.empty_atlas(CFG)
    ids = jnp.asarray([5, 6, 7], dtype=jnp.int64)
    atlas, slots = A.allocate_tiles(atlas, ids, jnp.asarray(0, dtype=jnp.int32))
    view = A.extract_view(atlas, slots, jnp.ones(3, dtype=bool), CFG)
    assert not np.any(np.asarray(view.valid))
    assert view.positions.shape == (3 * CFG.m_tile_view, 3)


def test_merge_reduce_zero_budget_is_noop():
    """k_merge_pairs_tile=0 must disable merging without crashing (it used to
    fail at trace time with a 0-size indexing error)."""
    import dataclasses

    cfg = dataclasses.replace(PipelineConfig(), k_merge_pairs_tile=0)
    atlas = A.empty_atlas(cfg)
    slots = jnp.arange(3, dtype=jnp.int32)
    atlas2, n_merged = A._merge_reduce(atlas, slots, cfg)
    assert int(n_merged) == 0
    for a, b in zip(atlas, atlas2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_merge_reduce_merges_near_pair_only():
    """Two near-duplicate Gaussians in a tile merge (moment-matched, weights
    add, loser invalidated); a distant one survives untouched."""
    cfg = CFG
    atlas = A.empty_atlas(cfg)
    Lam = np.eye(3) * 100.0  # sigma ~ 0.1 m
    mus = np.array([
        [1.0, 0.0, 0.5],      # near pair member 1
        [1.02, 0.0, 0.5],     # near pair member 2 (2 cm apart)
        [3.0, 2.0, 0.5],      # far
    ])
    T, M = atlas.weights.shape
    tslot = 2
    Lams = np.array(atlas.Lambdas)
    ths = np.array(atlas.thetas)
    ws = np.array(atlas.weights)
    vs = np.array(atlas.valid)
    pids = np.array(atlas.primitive_ids)
    for k, mu in enumerate(mus):
        Lams[tslot, k] = Lam
        ths[tslot, k] = Lam @ mu
        ws[tslot, k] = 1.0 + 0.1 * k
        vs[tslot, k] = True
        pids[tslot, k] = k
    atlas = atlas._replace(
        Lambdas=jnp.asarray(Lams), thetas=jnp.asarray(ths),
        weights=jnp.asarray(ws), valid=jnp.asarray(vs),
        primitive_ids=jnp.asarray(pids),
    )
    slots = jnp.asarray([tslot], dtype=jnp.int32)
    atlas2, n_merged = A._merge_reduce(atlas, slots, cfg)
    assert int(n_merged) == 1
    w2 = np.asarray(atlas2.weights)[tslot]
    v2 = np.asarray(atlas2.valid)[tslot]
    # winner carries the pair's summed weight; loser invalidated; far intact
    merged = np.where(np.isclose(w2, 2.1))[0]
    assert len(merged) == 1
    assert v2[2] and np.isclose(w2[2], 1.2)
    assert int(v2.sum()) == 2  # 3 -> 2 primitives
    # moment-matched mean lands between the pair
    k = merged[0]
    Lam_m = np.asarray(atlas2.Lambdas)[tslot, k]
    th_m = np.asarray(atlas2.thetas)[tslot, k]
    mu_m = np.linalg.solve(Lam_m, th_m)
    w1, w2b = 1.0, 1.1
    expect = (w1 * mus[0] + w2b * mus[1]) / (w1 + w2b)
    np.testing.assert_allclose(mu_m, expect, atol=1e-3)


# ---------------------------------------------------------------------------
# Slab-refactor regression tests: the 860525b refactor made
# every map mutation operate on the (A, M) active-tile slab. (a) guards the
# exact bug it fixed — scatter sentinels that wrap and clobber live slots on
# unfilled budgets; (b) asserts the slab semantics: op results depend ONLY on
# active-tile content (equivalent to running on a compacted atlas holding
# just those tiles), and non-active tiles are bit-untouched.
# ---------------------------------------------------------------------------

from gcslam_tpu.models.atlas import MapExtras, AtlasState
from gcslam_tpu.models.batch import MeasurementBatch


def _filled_atlas(cfg, tile_ids, rng, fill_frac=0.5, garbage=False):
    """Atlas with `tile_ids` allocated and random valid content; when
    `garbage`, every OTHER (unallocated) tile row also gets a recognizable
    nonzero pattern so any out-of-slab write is detectable."""
    atlas = A.empty_atlas(cfg)
    atlas, slots = A.allocate_tiles(
        atlas, jnp.asarray(tile_ids, dtype=jnp.int64), jnp.asarray(0, jnp.int32))
    T, M = atlas.weights.shape
    n_fill = max(2, int(M * fill_frac))
    Lams = np.zeros((T, M, 3, 3), np.float32)
    ths = np.zeros((T, M, 3), np.float32)
    etas = np.zeros((T, M, C.VMF_N_LOBES, 3), np.float32)
    ws = np.zeros((T, M), np.float32)
    vs = np.zeros((T, M), bool)
    pids = np.full((T, M), -1, np.int32)
    if garbage:  # non-active tiles only: active-tile residue must be
        # identical across atlas sizes for the equivalence test
        non = np.setdiff1d(np.arange(T), np.asarray(slots))
        ws[non] = 7.5
        pids[non] = 777
        Lams[non] = np.eye(3) * 3.25
    for j, (tid, s) in enumerate(zip(tile_ids, np.asarray(slots))):
        for k in range(n_fill):
            q = rng.normal(0, 0.3, (3, 3))
            Lams[s, k] = (q @ q.T + 2 * np.eye(3)) * 5
            mu = rng.uniform(-0.8, 0.8, 3)
            ths[s, k] = Lams[s, k] @ mu
            etas[s, k, 0] = rng.normal(0, 1, 3)
            ws[s, k] = rng.uniform(0.5, 3.0)
            vs[s, k] = True
            pids[s, k] = 1000 * j + k
    return atlas._replace(
        Lambdas=jnp.asarray(Lams), thetas=jnp.asarray(ths), etas=jnp.asarray(etas),
        weights=jnp.asarray(ws), valid=jnp.asarray(vs), primitive_ids=jnp.asarray(pids),
        cam_mass=jnp.asarray(ws * 0.1), lidar_mass=jnp.asarray(ws * 0.9),
        next_global_id=jnp.asarray(50_000, jnp.int32),
    ), slots


def _mk_inputs(cfg, atlas, slots, tile_ids, rng, n_meas=24, n_valid=None):
    """View + MapExtras + world-frame measurement batch over the stencil."""
    found = jnp.ones((len(tile_ids),), bool)
    view = A.extract_view(atlas, slots, found, cfg)
    N, K = n_meas, C.K_ASSOC
    if n_valid is None:
        n_valid = n_meas
    # measurement positions inside the active tiles (tile centers + jitter)
    tid_choice = rng.integers(0, len(tile_ids), N)
    # recover a point inside each chosen tile by searching the view pool
    pool_pos = np.asarray(view.positions)
    pool_valid = np.asarray(view.valid)
    base = np.zeros((N, 3))
    for i in range(N):
        rows = np.where(pool_valid)[0]
        base[i] = pool_pos[rows[rng.integers(0, len(rows))]]
    mu = base + rng.normal(0, 0.05, (N, 3))
    Lam = np.zeros((N, 3, 3), np.float32)
    for i in range(N):
        q = rng.normal(0, 0.3, (3, 3))
        Lam[i] = (q @ q.T + 2 * np.eye(3)) * 5
    th = np.einsum("nij,nj->ni", Lam, mu)
    etas = np.zeros((N, C.VMF_N_LOBES, 3), np.float32)
    etas[:, 0] = rng.normal(0, 1, (N, 3))
    valid = np.zeros(N, bool)
    valid[:n_valid] = True
    batch = MeasurementBatch(
        Lambdas=jnp.asarray(Lam * valid[:, None, None]),
        thetas=jnp.asarray(th * valid[:, None], dtype=jnp.float32),
        etas=jnp.asarray(etas * valid[:, None, None]),
        weights=jnp.asarray(rng.uniform(0.5, 2.0, N).astype(np.float32) * valid),
        sources=jnp.ones((N,), jnp.int32),
        valid=jnp.asarray(valid),
        timestamps=jnp.zeros((N,)),
        colors=jnp.full((N, 3), 0.5),
    )
    P = view.valid.shape[0]
    cand_pool = rng.integers(0, P, (N, K)).astype(np.int32)
    resp = rng.uniform(0, 1, (N, K)).astype(np.float32)
    resp = resp / resp.sum(1, keepdims=True) * rng.uniform(0.2, 0.9, (N, 1))
    resp = resp * valid[:, None]
    extras = MapExtras(
        batch=batch,
        responsibilities=jnp.asarray(resp),
        cand_pool=jnp.asarray(cand_pool),
        row_masses=jnp.asarray(resp.sum(1) * 0.0),  # zero -> positive novelty
        ot_transport_mass=jnp.asarray(0.5),
        ot_marginal_defect_a=jnp.asarray(0.01),
        z_map_pose=jnp.zeros(6),
        lidar_residuals=jnp.zeros((N, K, 3)),
        lidar_resid_w=jnp.asarray(resp),
    )
    return view, extras


def test_slab_sentinel_safety_unfilled_insert_budget():
    """Unfilled insert budgets must not write ANY slot beyond the real
    insertions — the exact 860525b bug class (-1 scatter sentinels wrap to
    the last slab slot even with mode='drop' and clobber it every scan)."""
    rng = np.random.default_rng(11)
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=16, m_tile=64,
                         m_tile_view=32, n_surfel=64, k_insert_tile=8)
    tile_ids = [101, 202, 303, 404]
    atlas, slots = _filled_atlas(cfg, tile_ids, rng, garbage=True)
    # ONE valid measurement => at most one insert; budget is 4 tiles x 8
    view, extras = _mk_inputs(cfg, atlas, slots, tile_ids, rng,
                              n_meas=24, n_valid=1)
    mu_w = np.asarray(
        __import__("gcslam_tpu.models.batch", fromlist=["mean_positions"])
        .mean_positions(extras.batch, cfg.eps_lift))
    atlas2, insert_mass, evicted_mass, ev = A._insert(
        atlas, extras, jnp.asarray(mu_w),
        extras.batch.Lambdas, extras.batch.thetas, extras.batch.etas,
        slots, jnp.asarray(tile_ids, jnp.int64),
        jnp.asarray(3, jnp.int32), jnp.asarray(1.5), cfg)
    sl = np.asarray(slots)
    act = np.zeros(atlas.weights.shape[0], bool)
    act[sl] = True
    # non-active tiles: bit-identical in EVERY channel
    for name in AtlasState._fields:
        a0, a1 = np.asarray(getattr(atlas, name)), np.asarray(getattr(atlas2, name))
        if a0.ndim == 0 or a0.shape[0] != act.shape[0] or name == "tile_ids":
            continue
        np.testing.assert_array_equal(a0[~act], a1[~act], err_msg=name)
    # active tiles: at most ONE slot changed anywhere (the single insert);
    # in particular the last slot of the last active tile (the wrap target)
    # is untouched
    changed = 0
    for s in sl:
        diff = (np.asarray(atlas.weights)[s] != np.asarray(atlas2.weights)[s]) | (
            np.asarray(atlas.primitive_ids)[s] != np.asarray(atlas2.primitive_ids)[s])
        changed += int(diff.sum())
    assert changed <= 1, changed
    last = sl[-1]
    assert np.asarray(atlas2.weights)[last, -1] == np.asarray(atlas.weights)[last, -1]
    assert np.asarray(atlas2.primitive_ids)[last, -1] == np.asarray(atlas.primitive_ids)[last, -1]


def test_slab_equivalence_compact_atlas():
    """map_update_step on a 16-tile atlas with 4 active tiles must produce,
    in those tiles, EXACTLY the state produced on a compacted 8-tile atlas
    holding only those tiles (same slab order) — i.e. the slab ops read and
    write nothing outside the stencil. Also: non-active tiles bit-unchanged."""
    rng_seed = 12
    ids = [11, 22, 33, 44]

    def run(cfg):
        rng = np.random.default_rng(rng_seed)
        atlas, slots = _filled_atlas(cfg, ids, rng, garbage=(cfg.atlas_max_tiles == 16))
        rng2 = np.random.default_rng(99)
        view, extras = _mk_inputs(cfg, atlas, slots, ids, rng2, n_meas=24)
        atlas2, tape = A.map_update_step(
            atlas, view, extras, jnp.zeros(6), slots,
            jnp.asarray(ids, jnp.int64), jnp.asarray(3, jnp.int32),
            jnp.asarray(1.5), cfg)
        return atlas, atlas2, np.asarray(slots)

    big = PipelineConfig(with_map=True, atlas_max_tiles=16, m_tile=64,
                         m_tile_view=32, n_surfel=64, k_insert_tile=8)
    small = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64,
                           m_tile_view=32, n_surfel=64, k_insert_tile=8)
    atlas_b0, atlas_b, sl_b = run(big)
    atlas_s0, atlas_s, sl_s = run(small)

    per_tile = [f for f in AtlasState._fields
                if f not in ("tile_ids", "tile_last_active", "next_global_id")]
    for name in per_tile:
        xb = np.asarray(getattr(atlas_b, name))[sl_b]
        xs = np.asarray(getattr(atlas_s, name))[sl_s]
        np.testing.assert_array_equal(xb, xs, err_msg=name)
    # non-active tiles of the big atlas: bit-unchanged garbage
    act = np.zeros(16, bool)
    act[sl_b] = True
    for name in per_tile:
        x0 = np.asarray(getattr(atlas_b0, name))
        x1 = np.asarray(getattr(atlas_b, name))
        np.testing.assert_array_equal(x0[~act], x1[~act], err_msg=name)
