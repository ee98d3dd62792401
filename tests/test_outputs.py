"""Rendering / checkpoint / audit / manifest tests."""

import json

import numpy as np
import pytest

import jax
from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.models.scan_step import init_state
from gcslam_tpu.models.manifest import runtime_manifest, manifest_json
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
from gcslam_tpu.outputs.rendering import render_splats, RenderParams
from gcslam_tpu.utils import checkpoint

SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64,
             n_surfel=128, surfel_voxel_size_m=0.5)


def test_render_splats_basic():
    # one red splat straight ahead
    mu = jnp.asarray([[0.0, 0.0, 2.0]])
    Sigma = jnp.asarray([np.eye(3) * 0.01])
    etas = jnp.zeros((1, 3, 3))
    colors = jnp.asarray([[1.0, 0.0, 0.0]])
    masses = jnp.asarray([10.0])
    cam = jnp.zeros(6)
    rgb, depth = render_splats(mu, Sigma, etas, colors, masses, cam,
                               RenderParams(width=64, height=48, fx=48.0, fy=48.0))
    rgb = np.asarray(rgb)
    assert rgb.shape == (48, 64, 3)
    cy, cx = 24, 32
    assert rgb[cy, cx, 0] > 0.1  # red at center
    assert rgb[cy, cx, 0] > rgb[cy, cx, 2]
    assert abs(float(depth[cy, cx]) - 2.0) < 0.2
    assert rgb[0, 0].max() < 0.05  # corners empty


def test_checkpoint_roundtrip(tmp_path):
    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=3, n_points=256))
    state = init_state(cfg)
    for b in run.batches:
        state, out = runner._step_jit(state, b, cfg)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(path, state)
    restored = checkpoint.load_state(path, init_state(cfg))
    # resumed run continues identically
    s1, o1 = runner._step_jit(state, run.batches[0], cfg)
    s2, o2 = runner._step_jit(restored, run.batches[0], cfg)
    np.testing.assert_array_equal(np.asarray(o1.pose), np.asarray(o2.pose))


def test_manifest_contains_budgets():
    cfg = PipelineConfig(**SMALL)
    man = runtime_manifest(cfg)
    assert man["chart_id"] == "GC-RIGHT-01"
    assert man["config.k_hyp"] == 4
    assert man["config.n_points_cap"] == 8192
    assert "backends" in man
    # the Sinkhorn backend this process runs, not a fixed string
    assert man["backends"]["sinkhorn_backend"] == "xla"  # CPU resolves "auto" to xla
    json.loads(manifest_json(cfg))  # valid JSON


def test_audit_on_eval_run(tmp_path):
    from gcslam_tpu.eval import run as eval_run
    from gcslam_tpu.eval.audit import audit_run

    out = str(tmp_path / "run")
    eval_run.main(["--cpu", "--scans", "8", "--points", "512", "--out", out])
    res = audit_run(out)
    assert res["all_pass"], json.dumps(res, indent=2)


def test_incremental_map_stream(tmp_path):
    """Streaming mode exports periodic atlas snapshots + an index — the
    offline analog of the reference's live /gc/map publisher
    (backend/map_publisher.py:90)."""
    import json

    import numpy as np

    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.config import PipelineConfig

    run = generate(SyntheticConfig(n_scans=7, n_points=256))
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64,
                         m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
    d = str(tmp_path / "stream")
    state, out = runner.run_stream(run.batches, cfg, map_stream_dir=d,
                                   map_stream_every=3)
    lines = [json.loads(l) for l in open(f"{d}/map_stream.jsonl")]
    assert [e["scan"] for e in lines] == [0, 3, 6]
    last = np.load(f"{d}/{lines[-1]['file']}")
    assert lines[-1]["n_splats"] > 0
    assert last["mu_world"].shape[0] == lines[-1]["n_splats"]


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Orbax save/restore of a mesh-sharded sweep state: values AND
    shardings survive; a run resumed from the checkpoint matches an
    uninterrupted run exactly."""
    import numpy as np
    from gcslam_tpu.utils.xla import jax
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.parallel import sweep
    from gcslam_tpu.utils import checkpoint as ckpt
    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.models.scan_io import stack_scan_batches

    n_runs = 2
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64,
                         m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
    packs = [stack_scan_batches(
        generate(SyntheticConfig(n_scans=4, n_points=256, seed=s)).batches)
        for s in range(n_runs)]
    batches = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs), *packs)
    mesh = sweep.make_mesh(n_runs)
    states = sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh)

    def step(states, k):
        bk = jax.tree_util.tree_map(lambda x: x[:, k], batches)
        bk = sweep.shard_batches(bk, mesh)
        states, outs, _ = sweep.sweep_step(states, bk, cfg)
        return states, np.asarray(outs.pose)

    states, _ = step(states, 0)
    states, _ = step(states, 1)
    ckpt.save_state_sharded(str(tmp_path / "ckpt"), states)

    resumed = ckpt.load_state_sharded(
        str(tmp_path / "ckpt"),
        sweep.shard_states(sweep.batched_init_state(cfg, n_runs), mesh),
    )
    # placement preserved
    assert resumed.hyp_weights.sharding == states.hyp_weights.sharding
    # resumed run matches the uninterrupted one bit-for-bit
    s_cont, p_cont = step(states, 2)
    s_res, p_res = step(resumed, 2)
    assert np.array_equal(p_cont, p_res)


def test_live_view_file_backend(tmp_path):
    """LiveViewer without the rerun SDK: tail-able live.jsonl + point/map
    snapshots through run_stream (reference live-Rerun mode analog)."""
    import json

    import numpy as np

    from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
    from gcslam_tpu.models import runner
    from gcslam_tpu.models.config import PipelineConfig
    from gcslam_tpu.outputs.live_view import LiveViewer

    run = generate(SyntheticConfig(n_scans=7, n_points=256))
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=8, m_tile=64,
                         m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
    d = str(tmp_path / "live")
    viewer = LiveViewer(d, points_every=3, map_every=5)
    assert viewer.backend == "file"  # no rerun SDK in this image
    runner.run_stream(run.batches, cfg, live_viewer=viewer)
    lines = [json.loads(l) for l in open(f"{d}/live.jsonl")]
    scans = [e["scan"] for e in lines if "pose" in e]
    assert scans == list(range(7))
    # points every 3rd scan, map every 5th
    pts = [e for e in lines if "points_file" in e]
    assert [e["scan"] for e in pts] == [0, 3, 6]
    arr = np.load(f"{d}/{pts[0]['points_file']}")["points"]
    assert arr.ndim == 2 and arr.shape[1] == 3
    maps = [e for e in lines if "map_file" in e]
    assert [e["scan"] for e in maps] == [0, 5]
    assert maps[-1]["n_splats"] >= 0
    for e in lines:
        if "pose" in e:
            assert np.all(np.isfinite(e["pose"]))
