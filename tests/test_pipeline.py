"""End-to-end pipeline invariants on synthetic data (models the reference's
audit-invariant + budget suites, test_audit_invariants.py /
test_budget_assertions.py)."""

import numpy as np
import pytest

import jax
from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.models.scan_step import init_state
from gcslam_tpu.models.scan_io import empty_scan_batch
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

SMALL = dict(
    with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64,
    n_surfel=128, surfel_voxel_size_m=0.5,
)


_TEST_COUNT = {"n": 0}


@pytest.fixture(autouse=True)
def _clear_caches_every_few_tests():
    """Bounded executable accumulation for THIS file only.

    This file alone accumulates enough XLA CPU executables that the 13th
    test's compile segfaults backend_compile_and_load deterministically
    (reproduced round 4). Round 4 cleared after EVERY test — safe, but
    recompiling everything each test made this file alone cost 27 min.
    Clearing every 4th test keeps accumulation far below the ~13-test
    crash point while letting the shared-SMALL-config tests reuse compiles;
    the persistent test cache (conftest) makes post-clear recompiles disk
    hits rather than fresh LLVM runs.
    """
    yield
    _TEST_COUNT["n"] += 1
    if _TEST_COUNT["n"] % 4 == 0:
        jax.clear_caches()


@pytest.fixture(scope="module")
def small_run():
    return generate(SyntheticConfig(n_scans=10, n_points=512))


def test_end_to_end_finite_and_tracks(small_run):
    cfg = PipelineConfig(**SMALL)
    state, out = runner.run_bag(small_run.batches, cfg)
    poses = np.asarray(out.pose)
    assert np.all(np.isfinite(poses))
    err = np.linalg.norm(poses[:, :2] - small_run.gt_poses[:, :2], axis=1)
    assert err[-1] < 0.5  # tracks within 0.5 m over 1 s of motion
    # certificates finite
    for field in out.tape._fields:
        arr = np.asarray(getattr(out.tape, field))
        assert np.all(np.isfinite(arr.astype(np.float64))), field


def test_determinism(small_run):
    """Identical inputs => identical outputs (the reference's determinism
    contract, docs/GC_SLAM.md:1150)."""
    cfg = PipelineConfig(**SMALL)
    _, out1 = runner.run_bag(small_run.batches, cfg)
    _, out2 = runner.run_bag(small_run.batches, cfg)
    np.testing.assert_array_equal(np.asarray(out1.pose), np.asarray(out2.pose))


def test_empty_scan_stays_finite(small_run):
    """Graceful degradation: a completely empty scan must not produce NaNs
    (reference backend_node.py:1700-1707 empty-scan dummy point)."""
    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    state, _ = runner._step_jit(state, small_run.batches[0], cfg)
    b = small_run.batches[1]
    eb = empty_scan_batch(n_points=512)._replace(
        scan_start_time=b.scan_start_time, scan_end_time=b.scan_end_time,
        t_scan=b.t_scan, t_last_scan=b.t_last_scan, dt_sec=b.dt_sec, scan_seq=b.scan_seq,
    )
    state, out = runner._step_jit(state, eb, cfg)
    assert np.all(np.isfinite(np.asarray(out.pose)))
    state, out2 = runner._step_jit(state, small_run.batches[2], cfg)
    assert np.all(np.isfinite(np.asarray(out2.pose)))


def test_hypothesis_permutation_invariance(small_run):
    """Barycenter output must be invariant to hypothesis ordering
    (reference test_audit_invariants.py order-invariance)."""
    from gcslam_tpu.ops.hypothesis import hypothesis_barycenter

    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    state, _ = runner._step_jit(state, small_run.batches[0], cfg)
    beliefs = state.beliefs
    w = jnp.asarray([0.4, 0.3, 0.2, 0.1])
    out1, _ = hypothesis_barycenter(beliefs, w)
    perm = jnp.asarray([2, 0, 3, 1])
    beliefs_p = jax.tree_util.tree_map(lambda x: x[perm], beliefs)
    out2, _ = hypothesis_barycenter(beliefs_p, w[perm])
    np.testing.assert_allclose(np.asarray(out1.belief.L), np.asarray(out2.belief.L), atol=1e-9)
    np.testing.assert_allclose(np.asarray(out1.belief.h), np.asarray(out2.belief.h), atol=1e-9)


def test_budget_fail_fast():
    with pytest.raises(ValueError, match="compile-time constant"):
        PipelineConfig(k_hyp=3).validate()


def test_fixed_shapes_across_scans(small_run):
    """JIT cache stability: the step compiles once for a config; all scans
    share shapes (reference spec 12.9 jit-cache-stability)."""
    cfg = PipelineConfig(**SMALL)
    state = init_state(cfg)
    for b in small_run.batches[:3]:
        shapes_before = jax.tree_util.tree_map(lambda x: getattr(x, "shape", None), state)
        state, out = runner._step_jit(state, b, cfg)
        shapes_after = jax.tree_util.tree_map(lambda x: getattr(x, "shape", None), state)
        assert shapes_before == shapes_after


def test_loop_closure_reduces_drift():
    """LoopFactor contract: late absolute-pose evidence pulls the estimate
    back after heavy odom drift (budgeted recompose absorbs it; no iterative
    optimization)."""
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig

    run = generate(SyntheticConfig(n_scans=24, n_points=512, odom_drift_pos_per_m=0.5,
                                   odom_drift_yaw_per_m=0.15, seed=9))
    cfg = PipelineConfig(with_map=False)
    batches_loop = []
    for i, b in enumerate(run.batches):
        if i >= 18:
            b = b._replace(
                loop_pose=jnp.asarray(run.gt_poses[i]),
                loop_cov=jnp.asarray(np.diag([1e-4] * 3 + [1e-5] * 3)),
                loop_weight=jnp.asarray(1.0),
            )
        batches_loop.append(b)
    _, out_plain = runner.run_bag(run.batches, cfg)
    _, out_loop = runner.run_bag(batches_loop, cfg)
    e_plain = np.linalg.norm(np.asarray(out_plain.pose)[-1, :2] - run.gt_poses[-1, :2])
    e_loop = np.linalg.norm(np.asarray(out_loop.pose)[-1, :2] - run.gt_poses[-1, :2])
    assert e_loop < e_plain
    assert e_loop < 0.3


def test_unobserved_block_iw_stays_bounded():
    """Process-noise IW must not self-inflate on unobserved blocks (the
    dt-variance runaway: dPsi = r r^T + Sigma_post feeds the Q-grown prior
    variance back as a pseudo-measurement of Q; ops/iw.process_iw_suffstats
    now weights suffstats by block observability)."""
    import numpy as np
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.models.scan_step import init_state

    run = generate(SyntheticConfig(n_scans=60, n_points=256, seed=0))
    cfg = PipelineConfig(with_map=False)
    state = init_state(cfg)
    q0 = float(np.asarray(state.process_iw.Psi[5])[0, 0] /
               max(float(np.asarray(state.process_iw.nu[5])) - 2, 0.1))
    state, out = runner.run_bag(run.batches, cfg)
    q1 = float(np.asarray(state.process_iw.Psi[5])[0, 0] /
               max(float(np.asarray(state.process_iw.nu[5])) - 2, 0.1))
    # dt block is unobserved: its IW mean must stay within 10x of the prior
    assert q1 < 10 * q0, (q0, q1)


def test_nonidentity_extrinsics_track():
    """Kimera-rig regime: sensor data generated in rotated/offset sensor
    frames, corrected by the frontend convention (rosbag.load_bag:414-454).
    Tracking quality must match the identity-extrinsics run — a sign/order
    error in the rotvec convention shows up as gross drift here."""
    # T_base_imu rotation ~92 deg about x (the real acl_jackal mounting),
    # T_base_lidar with a 10 cm offset + small tilt.
    ext = dict(T_base_imu=(-0.016, -0.030, 0.007, -1.603, 0.003, 0.0),
               T_base_lidar=(-0.065, -0.100, 0.109, -0.003, -0.069, 0.029))
    errs = {}
    for name, kw in [("identity", {}), ("kimera", ext)]:
        run = generate(SyntheticConfig(n_scans=15, n_points=512, seed=7, **kw))
        cfg = PipelineConfig(**SMALL)
        _, out = runner.run_bag(run.batches, cfg)
        poses = np.asarray(out.pose)
        assert np.all(np.isfinite(poses)), name
        errs[name] = float(np.linalg.norm(poses[:, :2] - run.gt_poses[:, :2], axis=1).max())
    assert errs["kimera"] < 2.0 * errs["identity"] + 0.05, errs


def test_chunked_matches_stream(small_run):
    """Chunked replay (lax.scan windows + boundary control) must produce the
    same trajectory as the per-scan streaming loop — it is the same program,
    differently dispatched. Remainder handling included (10 = 2x4 + 2).

    Tolerance note: the lax.scan body and the standalone step are separate
    XLA compilations with different fusion/reduction orders; the ~1e-9
    rounding difference is amplified by re-association to ~1e-5 over 10
    scans (measured). 1e-3 still catches any structural state-carry bug,
    which shows up at 1e-1+."""
    cfg = PipelineConfig(**SMALL)
    _, out_stream = runner.run_stream(small_run.batches, cfg)
    _, out_chunk = runner.run_chunked(small_run.batches, cfg, chunk=4)
    np.testing.assert_allclose(
        np.asarray(out_chunk.pose), np.asarray(out_stream.pose), atol=1e-3
    )
    assert out_chunk.pose.shape[0] == len(small_run.batches)


def test_chunked_loop_closure_fires():
    """Loop factors produced at chunk boundaries must still fire and be
    consumed — the feature the chunked mode exists to keep (vs whole-bag
    lax.scan, which can take no host feedback). Same loitering geometry as
    test_loop.test_stream_with_loops_runs_and_fires."""
    from gcslam_tpu.frontend.loop import LoopDetector, LoopConfig

    run = generate(SyntheticConfig(n_scans=60, n_points=1024,
                                   odom_drift_pos_per_m=0.08,
                                   odom_drift_yaw_per_m=0.04, seed=0))
    cfg = PipelineConfig(with_map=False)
    det = LoopDetector(LoopConfig(keyframe_every=5, min_index_gap=15,
                                  max_revisit_dist_m=3.0, cooldown_scans=10))
    _, out = runner.run_chunked(run.batches, cfg, chunk=8, loop_detector=det)
    poses = np.asarray(out.pose)
    assert np.isfinite(poses).all()
    fired = np.asarray(out.tape.io_loop_weight)
    assert (fired > 0).any(), "no loop factor fired through the chunked path"
    xy = np.linalg.norm(poses[:, :2] - run.gt_poses[:60, :2], axis=1)
    assert xy.max() < 1.5


def test_lidar_measurement_iw_adapts():
    """Third measurement-noise IW block (spec contract 6 'noise is a random
    variable'): the pipeline must FEED LiDAR association-residual suffstats
    every scan — Sigma_lidar moves off the datasheet prior toward the matched
    residual scale (reference measurement_noise_iw_jax.py:104-131 via
    pipeline.py:550-566). (End-to-end the adapted value tracks the TOTAL
    residual budget — sensor noise + voxel aliasing + map error — under the
    association's support, so the clean-vs-noisy ORDERING is asserted at the
    suffstats level in test_lidar_iw_mode_tracks_residual_scale, not here.)"""
    from gcslam_tpu.ops import iw

    run = generate(SyntheticConfig(n_scans=12, n_points=512, seed=3))
    cfg = PipelineConfig(**SMALL)
    state, out = runner.run_bag(run.batches, cfg)
    Sig_l = np.asarray(iw.measurement_noise_mode(state.meas_iw, 2))
    assert np.all(np.isfinite(Sig_l))
    adapted = float(np.trace(Sig_l))
    prior = float(np.trace(np.asarray(
        iw.measurement_noise_mode(init_state(cfg).meas_iw, 2))))
    # the block is WIRED: the mode moved well off the prior
    assert abs(adapted - prior) / prior > 0.5, (adapted, prior)


def test_lidar_iw_mode_tracks_residual_scale():
    """Repeatedly applying residuals of std s drives the IW mode toward s^2
    (per axis) — and larger s => larger Sigma. The ordering contract of the
    adaptive noise loop, tested where it is well-defined."""
    from gcslam_tpu.ops import iw

    rng = np.random.default_rng(0)
    modes = []
    for s in (0.02, 0.1):
        state = iw.datasheet_measurement_noise()
        for _ in range(60):
            r = jnp.asarray(rng.normal(0.0, s, (64, 3)))
            dPsi, dnu = iw.lidar_meas_suffstats(r, jnp.full((64,), 1.0))
            state, _ = iw.measurement_iw_apply(state, dPsi, dnu)
        mode = np.asarray(iw.measurement_noise_mode(state, 2))
        modes.append(float(np.trace(mode)) / 3.0)
        # converged within 3x of the injected variance
        assert 0.3 * s**2 < modes[-1] < 3.0 * s**2, (s, modes[-1])
    assert modes[1] > modes[0]


def test_lidar_iw_feeds_surfel_noise_floor():
    """The adapted Sigma_lidar must be CONSUMED: a larger sensor_var widens
    the surfel covariance (lower precision) — closing the loop the reference
    closes via pipeline.py:550-566."""
    from gcslam_tpu.ops.surfels import extract_surfels

    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(-2, 2, (512, 3)))
    t = jnp.zeros(512)
    w = jnp.ones(512)
    s_small, _ = extract_surfels(pts, t, w, 64, 0.5, 3,
                                 sensor_var=jnp.asarray(1e-6))
    s_big, _ = extract_surfels(pts, t, w, 64, 0.5, 3,
                               sensor_var=jnp.asarray(1e-2))
    v = np.asarray(s_small.valid)
    assert v.any()
    tr_small = np.trace(np.asarray(s_small.Lambdas)[v], axis1=1, axis2=2)
    tr_big = np.trace(np.asarray(s_big.Lambdas)[v], axis1=1, axis2=2)
    assert np.all(tr_big <= tr_small + 1e-9)
    assert tr_big.mean() < 0.9 * tr_small.mean()


def test_lidar_iw_suffstats_support_weighting():
    """Zero matched mass must contribute ~no pseudo-observation (the map-empty
    startup case); full mass contributes dnu ~= 1 (reference dnu=1/scan)."""
    from gcslam_tpu.ops import iw

    r = jnp.ones((8, 3)) * 0.1
    dPsi0, dnu0 = iw.lidar_meas_suffstats(r, jnp.zeros((8,)))
    assert float(dnu0[2]) < 1e-6
    assert float(np.abs(np.asarray(dPsi0)).max()) < 1e-6
    dPsi1, dnu1 = iw.lidar_meas_suffstats(r, jnp.full((8,), 10.0))
    assert float(dnu1[2]) > 0.99
    np.testing.assert_allclose(np.asarray(dPsi1[2]), float(dnu1[2]) * 0.01 * np.ones((3, 3)),
                               rtol=1e-6)


def test_hypothesis_diversification(small_run):
    """hyp_diversify runs distinct evidence-trust profiles: beliefs separate,
    weights move toward the best-fitting profile; with it off, hypotheses
    stay bit-identical (reference parity)."""
    cfg_on = PipelineConfig(**SMALL, hyp_diversify=True)
    cfg_off = PipelineConfig(**SMALL, hyp_diversify=False)
    s_on, _ = runner.run_bag(small_run.batches, cfg_on)
    s_off, _ = runner.run_bag(small_run.batches, cfg_off)
    L_on = np.asarray(s_on.beliefs.L)
    L_off = np.asarray(s_off.beliefs.L)
    # off: all hypotheses identical
    assert np.allclose(L_off[0], L_off[1]) and np.allclose(L_off[0], L_off[3])
    # on: trust profiles separate the posteriors
    assert not np.allclose(L_on[0], L_on[1])
    w = np.asarray(s_on.hyp_weights)
    assert abs(w.sum() - 1.0) < 1e-9 and w.min() >= 0
    # weights moved off the uniform prior
    assert np.abs(w - 0.25).max() > 1e-4


def test_chunked_stacked_input_matches_list(small_run):
    """run_chunked must accept an already-stacked ScanBatch (the live
    frontend's staging ring buffer) and produce the identical trajectory —
    the host stacking is pure data motion, not semantics."""
    from gcslam_tpu.models.scan_io import stack_scan_batches

    cfg = PipelineConfig(**SMALL)
    _, out_list = runner.run_chunked(small_run.batches, cfg, chunk=4)
    stacked = stack_scan_batches(small_run.batches)
    _, out_stacked = runner.run_chunked(stacked, cfg, chunk=4)
    np.testing.assert_array_equal(
        np.asarray(out_list.pose), np.asarray(out_stacked.pose))
    # remainder path too (10 scans, chunk=4 => 2 through _step_jit)
    assert out_stacked.pose.shape[0] == len(small_run.batches)


def test_integrated_odom_is_dead_reckoned():
    """odom_model='integrated' must produce odometry that IS the composition
    of its own per-scan relative measurements (the encoder property): the
    reported odom z-yaw chain re-integrates to the reported poses, and
    heading drift therefore bends position (additive mode keeps them
    independent)."""
    run = generate(SyntheticConfig(n_scans=80, n_points=256,
                                   odom_model="integrated",
                                   odom_pos_noise_std=0.0,
                                   odom_yaw_noise_std=0.0, seed=2))
    odom = np.stack([np.asarray(b.odom_pose) for b in run.batches])
    rels = [np.asarray(b.odom_rel_pose) for b in run.batches]
    # dead-reckon the relative chain from the first reported pose
    p = odom[0].copy()
    for k in range(1, len(rels)):
        yaw = p[5]
        Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                       [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        p = np.concatenate([p[:3] + Rz @ rels[k][:3],
                            [0.0, 0.0, p[5] + rels[k][5]]])
        np.testing.assert_allclose(p[:3], odom[k, :3], atol=1e-9)
        np.testing.assert_allclose(p[5], odom[k, 5], atol=1e-9)


def test_hypothesis_sharing_modes_track(small_run):
    """The per-hypothesis map branch (reference semantics: extraction +
    GN per hypothesis, backend/pipeline.py:789) and the two cross-hypothesis sharing
    levels (map_share_extraction: shared surfels/shortlist;
    map_gn_shared: one GN chain from the predicted pose) must all track the
    trajectory — the sharing is a declared approximation over sub-voxel
    deskew differences, not a behavior change. The default is fully shared."""
    results = {}
    for name, kw in {
        "per_hyp": dict(map_share_extraction=False, map_gn_shared=False),
        "shared_extraction": dict(map_share_extraction=True, map_gn_shared=False),
        "shared_gn": dict(map_share_extraction=True, map_gn_shared=True),
    }.items():
        cfg = PipelineConfig(**SMALL, **kw)
        _, out = runner.run_bag(small_run.batches, cfg)
        poses = np.asarray(out.pose)
        assert np.all(np.isfinite(poses)), name
        err = np.linalg.norm(poses[:, :2] - small_run.gt_poses[:, :2], axis=1)
        results[name] = float(np.sqrt((err**2).mean()))
        assert results[name] < 0.5, (name, results[name])
    # sharing must not change the answer materially on a nominal run
    assert abs(results["shared_gn"] - results["per_hyp"]) < 0.05, results
    # the shared modes carry the declared approximation trigger
    from gcslam_tpu.ops.certs import TRIGGERS

    cfg = PipelineConfig(**SMALL)
    _, out = runner.run_bag(small_run.batches, cfg)
    masks = np.asarray(out.tape.cert_triggers).astype(np.uint64)
    assert (masks & np.uint64(TRIGGERS["hyp_shared_extraction"])).any()


def test_map_gn_shared_requires_share_extraction():
    with pytest.raises(ValueError):
        PipelineConfig(map_share_extraction=False, map_gn_shared=True).validate()
