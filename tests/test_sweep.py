"""Multi-run replay sweep sharded over an 8-device CPU mesh (parallel/sweep.py).

Checks the multi-device scale-out contract (SURVEY.md 2.10): N independent filter
states advance under one jitted step with the run axis sharded over the
mesh, results match the unsharded reference run, and different per-run
inputs give different per-run trajectories.
"""

import numpy as np

from gcslam_tpu.utils.xla import jax, jnp
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.parallel import sweep
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
from gcslam_tpu.models.scan_io import stack_scan_batches
from gcslam_tpu.models import runner


def _runs(n_runs, n_scans=6):
    packs = []
    for seed in range(n_runs):
        run = generate(SyntheticConfig(n_scans=n_scans, n_points=256, seed=seed))
        packs.append(stack_scan_batches(run.batches))
    # (runs, scans, ...) -> per-scan slices later
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *packs)


def test_sweep_matches_single_and_shards():
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest must force an 8-device CPU topology"
    n_runs = 8
    cfg = PipelineConfig(with_map=False)
    batches = _runs(n_runs)

    mesh = sweep.make_mesh()
    states = sweep.batched_init_state(cfg, n_runs)
    states = sweep.shard_states(states, mesh)

    n_scans = int(np.asarray(batches.t_scan).shape[1])
    poses = []
    for k in range(n_scans):
        bk = jax.tree_util.tree_map(lambda x: x[:, k], batches)
        bk = sweep.shard_batches(bk, mesh)
        states, outs, agg = sweep.sweep_step(states, bk, cfg)
        poses.append(np.asarray(outs.pose))
    poses = np.stack(poses, axis=1)  # (runs, scans, 6)

    # per-run trajectories differ (different seeds)
    assert np.abs(poses[0] - poses[1]).max() > 1e-4

    # run 0 matches an unsharded single replay exactly (same program)
    run0 = generate(SyntheticConfig(n_scans=n_scans, n_points=256, seed=0))
    _, out_single = runner.run_bag(run0.batches, cfg)
    single = np.asarray(out_single.pose)
    assert np.allclose(poses[0], single, atol=1e-8), np.abs(poses[0] - single).max()

    # aggregates are finite and spread is positive
    assert np.isfinite(float(agg["pose_spread"]))
    assert float(agg["pose_spread"]) > 0


def test_sweep_2d_run_hyp_mesh_matches():
    """("run", "hyp") mesh: hypothesis axis sharded over devices. The
    cross-hyp reductions (barycenter, weight renorm, IW averaging) become
    collectives over the hyp mesh axis; results must match the 1-D run."""
    from gcslam_tpu import constants as C

    n_runs, n_hyp = 2, 4
    assert C.K_HYP % n_hyp == 0
    cfg = PipelineConfig(with_map=False, hyp_diversify=True)
    batches = _runs(n_runs, n_scans=4)

    def advance(states, mesh):
        poses = []
        n_scans = int(np.asarray(batches.t_scan).shape[1])
        for k in range(n_scans):
            bk = jax.tree_util.tree_map(lambda x: x[:, k], batches)
            bk = sweep.shard_batches(bk, mesh)
            states, outs, _ = sweep.sweep_step(states, bk, cfg)
            poses.append(np.asarray(outs.pose))
        return np.stack(poses, axis=1)

    mesh2 = sweep.make_mesh_2d(n_runs, n_hyp)
    s2 = sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh2)
    poses2 = advance(s2, mesh2)

    mesh1 = sweep.make_mesh(n_runs)
    s1 = sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh1)
    poses1 = advance(s1, mesh1)

    assert np.all(np.isfinite(poses2))
    assert np.allclose(poses2, poses1, atol=1e-8), np.abs(poses2 - poses1).max()


def test_sweep_map_axis_sharding_matches():
    """("run", "map") mesh: the atlas TILE axis shards over devices (maps
    bigger than one chip's HBM). Gathers/scatters against the sharded tile
    table become GSPMD collectives; results must match the 1-D run."""
    n_runs, n_map = 2, 4
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64,
                         m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
    assert cfg.atlas_max_tiles % n_map == 0
    batches = _runs(n_runs, n_scans=4)

    def advance(states, mesh):
        poses = []
        for k in range(int(np.asarray(batches.t_scan).shape[1])):
            bk = jax.tree_util.tree_map(lambda x: x[:, k], batches)
            bk = sweep.shard_batches(bk, mesh)
            states, outs, _ = sweep.sweep_step(states, bk, cfg)
            poses.append(np.asarray(outs.pose))
        return np.stack(poses, axis=1), states

    mesh_m = sweep.make_mesh_map(n_runs, n_map)
    sm = sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh_m)
    poses_m, states_m = advance(sm, mesh_m)

    mesh1 = sweep.make_mesh(n_runs)
    s1 = sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh1)
    poses1, states_1 = advance(s1, mesh1)

    assert np.all(np.isfinite(poses_m))
    assert np.allclose(poses_m, poses1, atol=1e-8), np.abs(poses_m - poses1).max()
    # the sharded atlas accumulated the same map
    w_m = np.asarray(states_m.atlas.weights)
    w_1 = np.asarray(states_1.atlas.weights)
    assert np.allclose(w_m, w_1, atol=1e-5), np.abs(w_m - w_1).max()
