"""Duplicate-index accumulation primitives.

Every map-side accumulation in the pipeline is the same shape of problem:
`acc[idx[i]] += payload[i]` with DUPLICATE indices (surfel moments into hash
cells, association-weighted fuse into atlas slots). Two strategies: a plain
scatter-add ("scatter", the default everywhere; atomics on the GPU), or a
sort + segmented-sum + unique-index scatter ("sort"), which needs no
duplicate-index updates at all.

Numerical note: the two methods sum identical terms per bin in different
ORDERS (index order vs sorted order) — bit-identical in exact arithmetic,
within-rounding in f32. GCSLAM_SCATTER_METHOD=scatter|sort picks one for the
whole process ("auto" = scatter).

Reference parity: the reference accumulates the same sums with Python loops
over association blocks / numpy bincount (operators/lidar_surfel_extraction.py,
backend/pipeline.py:1258-1327); only the execution strategy differs here.
"""

from __future__ import annotations

import os

from gcslam_tpu.utils.xla import jax, jnp


def _method() -> str:
    m = os.environ.get("GCSLAM_SCATTER_METHOD", "auto")
    return m


def _resolved_method() -> str:
    m = _method()
    return "scatter" if m == "auto" else m


def scatter_accumulate(
    idx: jnp.ndarray,  # (N,) int32 bin ids; out-of-range [0, n_bins) rows drop
    payload: jnp.ndarray,  # (N, D)
    n_bins: int,
    method: str | None = None,
) -> jnp.ndarray:
    """acc (n_bins, D) with acc[b] = sum of payload rows where idx == b."""
    method = method or _resolved_method()
    N, D = payload.shape
    if method == "scatter":
        # mode="drop" only drops POSITIVE out-of-range targets; a negative
        # index WRAPS (adds into bin idx + n_bins). Route negatives to the
        # positive OOB sentinel so they really drop, per the docstring
        # contract (same wrap bug class as the old atlas _insert sentinel).
        idx_safe = jnp.where(idx >= 0, idx, jnp.int32(n_bins))
        return (
            jnp.zeros((n_bins, D), dtype=payload.dtype)
            .at[idx_safe].add(payload, mode="drop")
        )
    if method != "sort":
        raise ValueError(f"unknown scatter method {method!r}")

    # sort + segmented sum + unique-index scatter
    in_range = (idx >= 0) & (idx < n_bins)
    key = jnp.where(in_range, idx, n_bins).astype(jnp.int32)  # dropped rows last
    order = jnp.argsort(key)  # stable (iota tiebreak) — deterministic order
    key_s = key[order]
    pay_s = payload[order]
    csum = jnp.cumsum(pay_s.astype(payload.dtype), axis=0)
    # segment end = last row of each key run
    is_end = jnp.concatenate([key_s[1:] != key_s[:-1], jnp.ones((1,), dtype=bool)])
    # exclusive prefix before each segment start, gathered at its end row:
    # total(seg ending at i) = csum[i] - csum[start-1]; start-1 is the
    # previous end row. Build prev-end via the same mask shifted.
    # csum just before this segment = csum at the previous end row (or 0)
    prev_end = jnp.concatenate(
        [jnp.full((1,), -1, dtype=jnp.int32),
         jax.lax.cummax(jnp.where(is_end, jnp.arange(N, dtype=jnp.int32), -1))[:-1]]
    )
    base = jnp.where(prev_end[:, None] >= 0, csum[jnp.maximum(prev_end, 0)], 0.0)
    totals = csum - base  # valid at end rows
    # non-end rows get DISTINCT out-of-range targets (n_bins + row) so the
    # unique_indices promise holds for every row, dropped or not
    tgt = jnp.where(
        is_end & (key_s < n_bins), key_s, n_bins + jnp.arange(N, dtype=jnp.int32)
    )
    return (
        jnp.zeros((n_bins, D), dtype=payload.dtype)
        .at[tgt].set(totals, mode="drop", unique_indices=True)
    )
