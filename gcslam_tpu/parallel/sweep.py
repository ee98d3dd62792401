"""Multi-device batched replay: shard independent SLAM runs over a mesh.

The reference is a single-process single-device engine (SURVEY.md 2.10); its
only parallelism is a Python loop over K_HYP. The scale-out story here is
REPLAY SWEEPS: hypotheses x bags x noise-prior settings as a batch of
independent filter states, sharded over the devices with `jax.sharding`:

  - mesh axis "run": data-parallel independent replays (bags / seeds /
    prior settings). Each device advances its own filter; zero
    communication inside a step.
  - cross-run summaries (mean/max pose spread, certificate aggregates)
    are computed with jnp reductions over the sharded axis — XLA inserts
    the all-reduces (NCCL on GPUs, which reach each other all to all over
    NVLink, so the mesh layout follows the algorithm alone).

`sweep_step` is the full scan step; `replay_mesh_families` runs it on each
mesh family against a single-device replay (__graft_entry__.dryrun_multichip
on virtual CPU devices, chip_smoke.py --four on four GPUs).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from gcslam_tpu.utils.xla import jax, jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models.scan_io import ScanBatch
from gcslam_tpu.models.scan_step import StepState, init_state, scan_step


def make_mesh(n_devices: int | None = None, axis: str = "run") -> Mesh:
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.asarray(devs), (axis,))


def make_mesh_map(n_run: int, n_map: int) -> Mesh:
    """2-D mesh ("run", "map"): the atlas TILE axis shards over "map" so the
    device-resident map scales beyond one chip's HBM (the reference's
    unbounded dict-of-tiles has no analog; this is the multi-device version
    of its tile table). View extraction / fuse / insert gathers and scatters
    against the sharded tile table become GSPMD collectives; the rest of the
    filter state is replicated along "map". n_map must divide
    atlas_max_tiles."""
    devs = jax.devices()[: n_run * n_map]
    if len(devs) < n_run * n_map:
        raise ValueError(f"need {n_run * n_map} devices, have {len(devs)}")
    return Mesh(np.asarray(devs).reshape(n_run, n_map), ("run", "map"))


def make_mesh_2d(n_run: int, n_hyp: int) -> Mesh:
    """2-D mesh ("run", "hyp"): data-parallel replays x model-parallel
    hypotheses. The K_HYP axis of the belief stack shards over "hyp"; the
    cross-hypothesis reductions (weight normalization, barycenter einsum,
    IW suffstat averaging) become XLA all-reduces over the hyp axis of the
    mesh. n_hyp must divide K_HYP."""
    devs = jax.devices()[: n_run * n_hyp]
    if len(devs) < n_run * n_hyp:
        raise ValueError(f"need {n_run * n_hyp} devices, have {len(devs)}")
    return Mesh(np.asarray(devs).reshape(n_run, n_hyp), ("run", "hyp"))


def batched_init_state(config: PipelineConfig, n_runs: int) -> StepState:
    """Stack n_runs independent initial states along a leading run axis."""
    s0 = init_state(config)
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n_runs,) + x.shape), s0)


@functools.partial(jax.jit, static_argnames=("config",))
def sweep_step(states: StepState, batches: ScanBatch, config: PipelineConfig):
    """One scan for EVERY run in the sweep (leading run axis on both args),
    plus cross-run aggregates (all-reduced over the mesh when sharded)."""
    states_new, outs = jax.vmap(lambda s, b: scan_step(s, b, config))(states, batches)
    pose_mean = jnp.mean(outs.pose, axis=0)
    pose_spread = jnp.max(jnp.linalg.norm(outs.pose[:, :3] - pose_mean[None, :3], axis=-1))
    return states_new, outs, {"pose_mean": pose_mean, "pose_spread": pose_spread}


def shard_states(states: StepState, mesh: Mesh, axis: str = "run") -> StepState:
    """1-D run sharding; on a 2-D ("run", "hyp") mesh the hypothesis axis of
    the belief stack (and hyp_weights) additionally shards over "hyp"."""
    run = NamedSharding(mesh, P(axis))
    if "map" in mesh.axis_names:
        # atlas leaves are (R, T, ...): tile axis T shards over "map";
        # everything else replicates along "map".
        run_map = NamedSharding(mesh, P(axis, "map"))
        atlas = states.atlas
        if atlas is not None:
            atlas = type(atlas)(*[
                jax.device_put(x, run if jnp.ndim(x) < 2 else run_map)
                for x in atlas
            ])
        rest = states._replace(atlas=None)
        rest = jax.tree_util.tree_map(lambda x: jax.device_put(x, run), rest)
        return rest._replace(atlas=atlas)
    if "hyp" in mesh.axis_names:
        run_hyp = NamedSharding(mesh, P(axis, "hyp"))
        beliefs = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, run_hyp), states.beliefs
        )
        hyp_w = jax.device_put(states.hyp_weights, run_hyp)
        rest = states._replace(beliefs=None, hyp_weights=None)
        rest = jax.tree_util.tree_map(lambda x: jax.device_put(x, run), rest)
        return rest._replace(beliefs=beliefs, hyp_weights=hyp_w)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, run), states)


def shard_batches(batches: ScanBatch, mesh: Mesh, axis: str = "run") -> ScanBatch:
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), batches)


def mesh_families(n_devices: int, config: PipelineConfig) -> dict:
    """The mesh families a sweep runs on n_devices: name -> (mesh, n_runs).

    "run": n_devices independent replays; "run,hyp": the K_HYP axis sharded
    over up to 4 devices; "run,map": the atlas tile axis sharded over up to
    4 devices. A 2-D family is left out when no factor divides its axis."""
    from gcslam_tpu import constants as C

    fams = {"run": (make_mesh(n_devices), n_devices)}
    n_hyp = next((c for c in (4, 2) if n_devices % c == 0 and C.K_HYP % c == 0), 1)
    if n_hyp > 1:
        fams["run,hyp"] = (make_mesh_2d(n_devices // n_hyp, n_hyp), n_devices // n_hyp)
    n_map = next((c for c in (4, 2)
                  if n_devices % c == 0 and config.atlas_max_tiles % c == 0), 1)
    if n_map > 1:
        fams["run,map"] = (make_mesh_map(n_devices // n_map, n_map), n_devices // n_map)
    return fams


def _replay_sweep(step, states, batches, mesh=None):
    """Advance the sweep over every scan with `step` (a compiled
    sweep_step); returns (n_scans, R, 6) poses."""
    poses = []
    for b in batches:
        if mesh is not None:
            b = shard_batches(b, mesh)
        states, outs, _ = step(states, b)
        poses.append(outs.pose)
    jax.block_until_ready(poses[-1])
    return np.stack([np.asarray(p) for p in poses])


def replay_mesh_families(config: PipelineConfig, batches, n_devices: int,
                         log=print) -> dict:
    """Replay the same bag on a single device and on every mesh family over
    n_devices; every run of every family replays that bag, so each run's
    per-scan pose is compared with the single-device one.

    The programs (one per family, plus the single-device one) are lowered
    first and compiled all at once, one thread each. Returns name ->
    {"mesh", "runs", "finite", "max_abs_dpose", "compile_s", "replay_s"}."""
    import concurrent.futures as cf
    import contextlib
    import time

    def rep(n_runs):
        return [jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n_runs,) + jnp.shape(x)), b)
            for b in batches]

    runs = {"single": (None, 1), **mesh_families(n_devices, config)}
    jobs = {}
    for name, (mesh, n_runs) in runs.items():
        states = batched_init_state(config, n_runs)
        b0 = rep(n_runs)[0]
        if mesh is not None:
            states, b0 = shard_states(states, mesh), shard_batches(b0, mesh)
        with mesh if mesh is not None else contextlib.nullcontext():
            jobs[name] = (states, sweep_step.lower(states, b0, config))

    def compile_one(name):
        t0 = time.time()
        return name, jobs[name][1].compile(), time.time() - t0

    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        compiled = {n: (c, t) for n, c, t in ex.map(compile_one, jobs)}

    report = {}
    ref = None
    for name, (mesh, n_runs) in runs.items():
        t0 = time.time()
        step, compile_s = compiled[name]
        poses = _replay_sweep(step, jobs[name][0], rep(n_runs), mesh)
        if ref is None:
            ref = poses  # the single-device replay comes first
        report[name] = {
            "mesh": [1] if mesh is None else list(mesh.devices.shape), "runs": n_runs,
            "finite": bool(np.isfinite(poses).all()),
            "max_abs_dpose": float(np.abs(poses - ref).max()),
            "compile_s": compile_s, "replay_s": time.time() - t0,
        }
        r = report[name]
        log(f"{name} mesh {tuple(r['mesh'])}: {len(batches)} scans x {n_runs} runs, "
            f"max|pose - single device| = {r['max_abs_dpose']:.3e}, "
            f"compile {compile_s:.1f} s (concurrent), replay {r['replay_s']:.1f} s")
    return report
