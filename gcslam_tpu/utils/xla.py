"""Central JAX configuration (mirrors reference common/jax_init.py:1-35).

Precision policy:
  - x64 is ENABLED globally (uint64 trigger masks, f64 available).
  - The 22D belief algebra, IW states, and small dense factor math run in
    `BELIEF_DTYPE`. Default float64 for parity with the reference (its
    contract requires f64 for the belief algebra). Set env
    ``GCSLAM_BELIEF_DTYPE=float32`` BEFORE importing the package to run the
    belief algebra in f32 — the production mode of bench.py and
    chip_smoke.py, and the precision of the fused Sinkhorn kernel; the
    anchor-chart design keeps belief increments near zero, which is
    precisely what makes f32 viable (see tests/test_precision.py for the
    accuracy gate).
  - Point-cloud hot paths (deskew, binning, association cost, map scatter)
    explicitly use `POINT_DTYPE` (float32): the bulk arrays, where the
    device's f32 rate and bytes matter.

All modules must import `jax`/`jnp` from here (or after importing the
package) so x64 is enabled before any tracing happens.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)
# f32 matmuls may otherwise run at reduced precision (TF32 on the GPU's
# tensor cores, ~3 decimal digits) — fatal for the belief algebra in
# f32-belief mode (roundoff-indefinite 22x22 factors beyond any reasonable
# Cholesky ridge) and for point-association distances. "highest" forces
# true-f32 products; the small-matrix algebra is latency-bound, not
# throughput-bound.
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

# dtype for the belief algebra / evidence factors (22x22 and smaller).
_BELIEF_DTYPE_ENV = os.environ.get("GCSLAM_BELIEF_DTYPE", "float64")
if _BELIEF_DTYPE_ENV not in ("float64", "float32"):
    raise ValueError(
        f"GCSLAM_BELIEF_DTYPE must be 'float64' or 'float32', got {_BELIEF_DTYPE_ENV!r}"
    )
BELIEF_DTYPE = jnp.float64 if _BELIEF_DTYPE_ENV == "float64" else jnp.float32
# dtype for bulk point-cloud kernels (8192-point arrays and larger).
POINT_DTYPE = jnp.float32
# dtype for ABSOLUTE timestamps — always f64: real-bag stamps are epoch
# seconds (~1.7e9 s) where f32 resolution is ~100 s. Time DIFFERENCES are
# small and cast to BELIEF_DTYPE at the op boundaries (windows,
# preintegration, deskew) so the f32-belief mode stays stamp-exact.
TIME_DTYPE = jnp.float64

__all__ = ["jax", "jnp", "BELIEF_DTYPE", "POINT_DTYPE", "TIME_DTYPE"]
