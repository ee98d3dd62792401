"""Tracing / profiling utilities — the runtime-counters analog.

The reference counts host<->device bytes, host syncs, and JIT recompiles via
global Python counters (common/runtime_counters.py) because its pipeline is
Python-dispatched. Here a scan is ONE program, so the equivalents are:

  - StepTimer: wall per-step timing with explicit block_until_ready (the
    enable_timing path);
  - compile_count(): XLA compilation-cache size delta (the
    jit_recompile_count assertion — a stable pipeline compiles each config
    exactly once);
  - trace(): context manager around jax.profiler for xprof traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import jax


class StepTimer:
    def __init__(self):
        self.ms: List[float] = []

    @contextlib.contextmanager
    def measure(self, out_ref=None):
        t0 = time.perf_counter()
        yield
        if out_ref is not None:
            jax.block_until_ready(out_ref)
        self.ms.append((time.perf_counter() - t0) * 1000.0)

    def summary(self) -> dict:
        if not self.ms:
            return {}
        import numpy as np

        a = np.asarray(self.ms)
        return {
            "n": len(a),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "max_ms": float(a.max()),
        }


def compile_count() -> int:
    """Number of entries in jit caches (proxy for recompiles)."""
    from jax._src import pjit  # noqa: PLC0415

    try:
        return int(pjit._cpp_pjit_cache_fun_only.currsize)  # type: ignore[attr-defined]
    except Exception:
        return -1


class RuntimeCounters:
    """MEASURED host<->device accounting (reference
    common/runtime_counters.py:19-103): every transfer the runner performs
    goes through this ledger — device_put() commits arrays to device and
    counts the committed buffers' bytes; to_host() materializes device values
    on host and counts the readback + sync. Nothing is estimated from shapes;
    what was not routed through the ledger was not transferred by the runner."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.h2d_bytes = 0
        self.h2d_calls = 0
        self.d2h_bytes = 0
        self.host_syncs = 0

    def device_put(self, tree):
        placed = jax.device_put(tree)
        for leaf in jax.tree_util.tree_leaves(placed):
            self.h2d_bytes += int(getattr(leaf, "nbytes", 0))
        self.h2d_calls += 1
        return placed

    def to_host(self, x):
        import numpy as np

        arr = np.asarray(x)
        self.d2h_bytes += int(arr.nbytes)
        self.host_syncs += 1
        return arr

    def sync(self, x) -> None:
        jax.block_until_ready(x)
        self.host_syncs += 1

    def cert(self) -> dict:
        return {
            "h2d_bytes": int(self.h2d_bytes),
            "h2d_calls": int(self.h2d_calls),
            "d2h_bytes": int(self.d2h_bytes),
            "host_syncs": int(self.host_syncs),
            "jit_cache_entries": compile_count(),
        }


COUNTERS = RuntimeCounters()


def device_runtime_cert() -> dict:
    """Numeric DeviceRuntimeCert (reference certificates.py:298-316): the
    measured global transfer/sync ledger + jit-cache size (recompile proxy —
    a stable pipeline compiles each config exactly once)."""
    return COUNTERS.cert()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with xprof/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
