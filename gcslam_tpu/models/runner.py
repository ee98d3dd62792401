"""Run driver: stream scans through the jitted step, or lax.scan a whole bag.

Replaces the reference's ROS node + worker threads (backend_node.py:1340-1388):
the frontend is an offline reader producing fixed-shape ScanBatches; the
device does everything else. Two modes:
  - run_scan(): the entire bag as one lax.scan — maximal fusion, used by the
    benchmark and sweeps;
  - run_stream(): host loop calling the jitted step per scan — the streaming/
    online mode (double-buffered host->device transfer handled by JAX's async
    dispatch).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from gcslam_tpu.utils.xla import jax
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.ops.certs import TRIGGERS as _certs_TRIGGERS
from gcslam_tpu.models.scan_io import ScanBatch, stack_scan_batches
from gcslam_tpu.models.scan_step import StepState, StepOutput, init_state, scan_step


@functools.partial(jax.jit, static_argnames=("config",))
def _step_jit(state: StepState, batch: ScanBatch, config: PipelineConfig):
    return scan_step(state, batch, config)


class DeadEndMonitor:
    """Dead-end classification for the status stream (the reference publishes
    a dedicated /gc/dead_end_status consumed by its wiring auditor,
    frontend/audit/wiring_auditor.py:37-265; here the classification rides
    the status JSONL as a `dead_end` field).

    Evaluated at status-emission points (every ~5 s of scan time — a dead end
    is a sustained condition, not a per-scan blip):
      - ``stalled_pose``: pose displacement below `pose_eps_m` across
        `stall_windows` consecutive status windows WHILE point data is
        flowing (zero-data idling is stream starvation, not a filter stall);
      - ``exploding_triggers``: per-scan certificate trigger count above
        `trigger_ratio` x the running median (a healthy scan fires dozens of
        DECLARED approximation triggers across ops x hypotheses — only a
        departure from the run's own baseline is anomalous);
      - ``zero_ess``: evidence support ESS below `ess_floor` (the filter is
        running on priors only).
    Empty list = healthy.
    """

    def __init__(self, pose_eps_m: float = 0.02, stall_windows: int = 2,
                 trigger_ratio: float = 3.0, ess_floor: float = 1.0,
                 baseline_len: int = 20):
        self.pose_eps_m = pose_eps_m
        self.stall_windows = stall_windows
        self.trigger_ratio = trigger_ratio
        self.ess_floor = ess_floor
        self.baseline_len = baseline_len
        self._last_pose = None
        self._stall_count = 0
        self._trig_hist: list = []

    def update(self, pose_xyz, n_triggers_scan: float, ess_total: float,
               point_weight_sum: float) -> list:
        import numpy as np

        flags = []
        p = np.asarray(pose_xyz, dtype=float)
        if self._last_pose is not None:
            moved = float(np.linalg.norm(p - self._last_pose))
            if moved < self.pose_eps_m and point_weight_sum > 0.0:
                self._stall_count += 1
            else:
                self._stall_count = 0
            if self._stall_count >= self.stall_windows:
                flags.append("stalled_pose")
        self._last_pose = p
        if len(self._trig_hist) >= 3:
            base = float(np.median(self._trig_hist))
            if n_triggers_scan > self.trigger_ratio * max(base, 1.0):
                flags.append("exploding_triggers")
        self._trig_hist.append(float(n_triggers_scan))
        if len(self._trig_hist) > self.baseline_len:
            self._trig_hist.pop(0)
        if ess_total < self.ess_floor:
            flags.append("zero_ess")
        return flags


@functools.partial(jax.jit, static_argnames=("config",))
def run_scan(state0: StepState, batches: ScanBatch, config: PipelineConfig):
    """Whole-bag lax.scan: batches have a leading time axis.

    The tape rides through the scan PACKED (one (F,) vector instead of ~44
    individual 0-d outputs = ~40 fewer dynamic-update-slices and carry
    entries per scan, tools/hlo_census) and is unpacked once post-scan."""
    from gcslam_tpu.models.scan_step import pack_output, unpack_outputs

    def step(s, b):
        s, out = scan_step(s, b, config)
        return s, pack_output(out)

    state, packed = jax.lax.scan(step, state0, batches)
    return state, unpack_outputs(packed)


def run_stream(
    batches: List[ScanBatch],
    config: PipelineConfig,
    state: StepState | None = None,
    loop_detector=None,
    map_stream_dir: str | None = None,
    map_stream_every: int = 20,
    status_path: str | None = None,
    status_every: int = 50,
    live_viewer=None,
) -> Tuple[StepState, StepOutput]:
    """Host streaming loop over the jitted step; returns final state and
    stacked outputs (poses/tape gathered on device, one transfer at the end).

    `loop_detector` (frontend.loop.LoopDetector) enables loop-closure
    production: detection runs host-side between steps (this is the online
    mode — run_bag's single lax.scan cannot take host feedback), factors are
    injected into the batch's loop channel and consumed by the always-compiled
    in-graph loop evidence (weight 0 when absent), so enabling loops causes
    NO recompilation.

    `map_stream_dir` enables the incremental map stream — the offline
    replacement for the reference's live /gc/map publisher
    (backend/map_publisher.py:90): every `map_stream_every` scans the atlas
    is exported as a splat snapshot `map_NNNNNN.npz` plus an index line in
    `map_stream.jsonl` (scan index, stamp, splat count, file).

    `status_path` enables the periodic status stream — the offline analog of
    the reference's /gc/status JSON every 5 s (backend_node.py:2295-2332):
    every `status_every` scans (50 ~= 5 s at 10 Hz LiDAR) a JSON line with
    scan counters, pose, map size, per-scan trigger counts, and wall rate
    is appended (also the dead-end monitor surface: stalled pose / exploding
    triggers show up here long before end-of-run artifacts exist).

    `live_viewer` (outputs.live_view.LiveViewer) enables live visualization —
    the reference's live Rerun mode (rerun_visualizer.py:34): per-scan pose +
    periodic points/map logged to a spawned viewer (rerun SDK) or a tail-able
    file stream."""
    import numpy as np
    import time as _time

    from gcslam_tpu.utils.profiling import COUNTERS

    config.validate()
    if state is None:
        state = init_state(config)
    stream_idx_f = None
    if map_stream_dir is not None and config.with_map:
        import os

        os.makedirs(map_stream_dir, exist_ok=True)
        stream_idx_f = open(f"{map_stream_dir}/map_stream.jsonl", "w")
    status_f = open(status_path, "w") if status_path is not None else None
    dead_end = DeadEndMonitor() if status_path is not None else None
    t_start = _time.time()
    outs = []
    pose_prev = np.zeros(6)
    for i, batch in enumerate(batches):
        if loop_detector is not None and i > 0:
            hit = loop_detector.detect(
                i, pose_prev, np.asarray(batch.points), np.asarray(batch.point_weights)
            )
            if hit is not None:
                lp, lc, lw = hit
                batch = batch._replace(
                    loop_pose=jax.numpy.asarray(lp, dtype=batch.loop_pose.dtype),
                    loop_cov=jax.numpy.asarray(lc, dtype=batch.loop_cov.dtype),
                    loop_weight=jax.numpy.asarray(lw, dtype=batch.loop_weight.dtype),
                )
        state, out = _step_jit(state, COUNTERS.device_put(batch), config)
        outs.append(out)
        if loop_detector is not None:
            pose_prev = COUNTERS.to_host(out.pose)
            pose_cov = None
            if i % loop_detector.cfg.keyframe_every == 0:
                from gcslam_tpu.ops import linalg as _linalg
                import gcslam_tpu.constants as _C

                b0 = jax.tree_util.tree_map(lambda x: x[0], state.beliefs)
                Sig, _ = _linalg.spd_inverse_lifted(b0.L, config.eps_lift)
                pose_cov = COUNTERS.to_host(Sig)[_C.IDX_POSE, _C.IDX_POSE]
            loop_detector.store(
                i, pose_prev, np.asarray(batch.points), np.asarray(batch.point_weights),
                pose_cov,
            )
        if live_viewer is not None:
            live_viewer.log_scan(
                i, float(COUNTERS.to_host(out.stamp)), COUNTERS.to_host(out.pose),
                points=np.asarray(batch.points),
                weights=np.asarray(batch.point_weights),
                map_valid_total=float(out.tape.map_valid_total),
            )
            if config.with_map:
                live_viewer.maybe_log_map(i, state.atlas)
        if stream_idx_f is not None and (i % map_stream_every == 0 or i == len(batches) - 1):
            import json

            from gcslam_tpu.outputs.splat_export import save_splat_export

            snap = f"{map_stream_dir}/map_{i:06d}.npz"
            n_splats = save_splat_export(snap, state.atlas)
            stream_idx_f.write(json.dumps({
                "scan": i, "stamp": float(out.stamp), "n_splats": n_splats,
                "file": snap.rsplit("/", 1)[-1],
            }) + "\n")
            stream_idx_f.flush()
        if status_f is not None and (i % status_every == 0 or i == len(batches) - 1):
            import json

            wall = _time.time() - t_start
            pose_xyz = COUNTERS.to_host(out.pose)[:3]
            n_trig = float(out.tape.cert_n_triggers)
            ess = float(out.tape.support_ess_total)
            pw_sum = float(out.tape.io_point_weight_sum)
            status_f.write(json.dumps({
                "scan": i,
                "stamp": float(COUNTERS.to_host(out.stamp)),
                "pose_xyz": [round(float(x), 4) for x in pose_xyz],
                "map_valid_total": float(out.tape.map_valid_total),
                "n_triggers_scan": n_trig,
                "ess_total": round(ess, 3),
                # the NonFiniteEvidence trigger BIT, not cert_exact: exact is
                # 0 whenever any DECLARED approximation ran (i.e. every scan)
                "nonfinite_rejected": bool(
                    int(out.tape.cert_triggers)
                    & _certs_TRIGGERS["NonFiniteEvidence"]
                ),
                "loop_weight": float(out.tape.io_loop_weight),
                "dead_end": dead_end.update(pose_xyz, n_trig, ess, pw_sum),
                "wall_s": round(wall, 3),
                "scans_per_s": round((i + 1) / max(wall, 1e-9), 2),
            }) + "\n")
            status_f.flush()
    if stream_idx_f is not None:
        stream_idx_f.close()
    if live_viewer is not None:
        live_viewer.close()
    if status_f is not None:
        status_f.close()
    stacked = jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs), *outs)
    return state, stacked


def run_bag(
    batches: List[ScanBatch], config: PipelineConfig, state: StepState | None = None
) -> Tuple[StepState, StepOutput]:
    """Stack + lax.scan the whole bag (fastest replay path)."""
    from gcslam_tpu.utils.profiling import COUNTERS

    config.validate()
    if state is None:
        state = init_state(config)
    stacked_batches = COUNTERS.device_put(stack_scan_batches(batches))
    return run_scan(state, stacked_batches, config)


def make_device_stager(example: ScanBatch, chunk: int):
    """Device-side scan staging for overlapped streaming.

    Returns (empty_window, stage_one) where stage_one(buf, batch, k) writes
    scan `batch` into row k of the device-resident (chunk, ...) window via
    ONE jitted donated dynamic-update — the host's only per-scan work is the
    small h2d of that scan. Staging on the HOST instead (`stack_scan_batches`
    = dozens of np.stack memcpys under the GIL) in a producer thread
    contends with the dispatch thread for the GIL."""
    import jax.numpy as jnp

    def _zeros(x):
        x = jnp.asarray(x)
        return jnp.zeros((chunk,) + x.shape, dtype=x.dtype)

    empty = jax.tree_util.tree_map(_zeros, example)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def stage_one(buf, b, k):
        return jax.tree_util.tree_map(
            lambda B, x: jax.lax.dynamic_update_index_in_dim(
                B, jax.numpy.asarray(x, B.dtype), k, 0),
            buf, b,
        )

    return empty, stage_one


def run_chunked(
    batches: List[ScanBatch],
    config: PipelineConfig,
    chunk: int = 10,
    state: StepState | None = None,
    loop_detector=None,
) -> Tuple[StepState, StepOutput]:
    """Chunked streaming: lax.scan over fixed windows of `chunk` scans with
    host prefetch and loop-closure injection at chunk boundaries.

    This is the live-operation latency story (reference async worker
    backend_node.py:1340-1388): a host loop that dispatches the jitted step
    per scan pays the host->device round trip EVERY scan; whole-bag
    lax.scan amortizes it to ~nothing but takes no feedback. Chunking buys both: per-scan device time within ~1 of replay
    mode (ONE dispatch per `chunk` scans), while the host gets control every
    chunk boundary — where loop-closure detection runs against the chunk's
    outputs and factors are injected into the NEXT chunk's loop channel
    (compiled in; weight 0 when absent => no recompilation). A live robot
    runs this with chunk = accumulated scans per dispatch: at 10 Hz LiDAR,
    chunk=10 means issuing one 10-scan program per second whose device time
    is ~10 x replay ms — far under the arrival rate — at one chunk of
    detection latency for loop closures.

    The final len(batches) % chunk scans run through the per-scan jitted step
    (a second, smaller compile — paid once).

    Dispatch discipline: every device op issued from the host costs a
    launch and host time, so the steady-state loop issues exactly ONE
    program per chunk. All windows are pre-stacked and
    reshaped to (n_chunks, chunk, ...) up front; the per-chunk program takes
    the whole window tensor plus a chunk index and
    `lax.dynamic_index_in_dim`s its window on device. The loop factor rides
    in as three small arguments merged into the window head inside the
    program (weight 0 = keep the window's own channel), so loop injection
    never retraces.

    `batches` may also be an already-stacked ScanBatch (leading time axis, as
    produced by stack_scan_batches / a live frontend's staging ring buffer):
    the per-scan host stacking — the dominant steady-state host cost, ~25
    concat dispatches over the whole bag — is then skipped entirely."""
    import numpy as np

    from gcslam_tpu.utils.profiling import COUNTERS

    config.validate()
    if state is None:
        state = init_state(config)
    outs = []
    # a stacked ScanBatch is itself a (Named)tuple — detect by type, not shape
    pre_stacked = isinstance(batches, ScanBatch)
    if pre_stacked:
        stacked_all = batches
        n = int(stacked_all.points.shape[0])

        def batch_at(i: int) -> ScanBatch:
            return jax.tree_util.tree_map(lambda x: x[i], stacked_all)
    else:
        n = len(batches)

        def batch_at(i: int) -> ScanBatch:
            return batches[i]

    n_chunks = n // chunk
    n_full = n_chunks * chunk
    if n_chunks:
        head = (jax.tree_util.tree_map(lambda x: x[:n_full], stacked_all)
                if pre_stacked else stack_scan_batches(batches[:n_full]))
        windows = COUNTERS.device_put(jax.tree_util.tree_map(
            lambda x: x.reshape((n_chunks, chunk) + x.shape[1:]), head,
        ))
    lp = np.zeros(6)
    lc = np.eye(6)
    lw = 0.0
    for c in range(n_chunks):
        state, out = _chunk_jit(
            state, windows, c,
            jax.numpy.asarray(lp), jax.numpy.asarray(lc), jax.numpy.asarray(lw),
            config,
        )
        lp, lc, lw = np.zeros(6), np.eye(6), 0.0
        outs.append(out)
        if loop_detector is not None:
            # boundary work: store this chunk's keyframes, then probe a loop
            # for the next chunk's head pose
            poses = COUNTERS.to_host(out.pose)  # (chunk, 6)
            for j in range(chunk):
                i = c * chunk + j
                if i % loop_detector.cfg.keyframe_every:
                    continue  # store() drops non-keyframes; skip their d2h
                b = batch_at(i)
                loop_detector.store(
                    i, poses[j], np.asarray(b.points),
                    np.asarray(b.point_weights), None,
                )
            if (c + 1) * chunk < n:
                nb = batch_at((c + 1) * chunk)
                pending = loop_detector.detect(
                    (c + 1) * chunk, poses[-1], np.asarray(nb.points),
                    np.asarray(nb.point_weights),
                )
                if pending is not None:
                    lp, lc, lw = pending
    # remainder through the per-scan step
    for i in range(n_full, n):
        state, out = _step_jit(state, COUNTERS.device_put(batch_at(i)), config)
        outs.append(jax.tree_util.tree_map(lambda x: jax.numpy.expand_dims(x, 0), out))
    stacked = jax.tree_util.tree_map(
        lambda *xs: jax.numpy.concatenate(xs, axis=0), *outs
    )
    return state, stacked


@functools.partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def _chunk_jit(state, windows, c, loop_pose, loop_cov, loop_weight, config):
    """One chunk = ONE device program: slice window `c` out of the
    pre-staged (n_chunks, chunk, ...) batch tensor, merge the boundary loop
    factor into the window's first scan (no-op when weight == 0 — the
    window keeps any factor the replay already carries), lax.scan it."""
    jnp = jax.numpy
    w = jax.tree_util.tree_map(
        lambda x: jax.lax.dynamic_index_in_dim(x, c, 0, keepdims=False), windows
    )
    inject = loop_weight > 0
    w = w._replace(
        loop_pose=w.loop_pose.at[0].set(jnp.where(
            inject, loop_pose.astype(w.loop_pose.dtype), w.loop_pose[0])),
        loop_cov=w.loop_cov.at[0].set(jnp.where(
            inject, loop_cov.astype(w.loop_cov.dtype), w.loop_cov[0])),
        loop_weight=w.loop_weight.at[0].set(jnp.where(
            inject, jnp.asarray(loop_weight, w.loop_weight.dtype),
            w.loop_weight[0])),
    )
    from gcslam_tpu.models.scan_step import pack_output, unpack_outputs

    def _step(s, b):
        s, out = scan_step(s, b, config)
        return s, pack_output(out)

    state, packed = jax.lax.scan(_step, state, w)
    return state, unpack_outputs(packed)
