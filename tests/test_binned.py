"""scatter_accumulate: the two execution strategies must agree (the sort
path needs no duplicate-index updates; see ops/binned.py)."""

import numpy as np

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.ops.binned import scatter_accumulate


def _ref(idx, payload, n_bins):
    acc = np.zeros((n_bins, payload.shape[1]), dtype=np.float64)
    for i, b in enumerate(idx):
        if 0 <= b < n_bins:
            acc[b] += payload[i]
    return acc


def test_methods_agree_with_duplicates_and_oob():
    rng = np.random.default_rng(0)
    n_bins = 97
    idx = rng.integers(-5, n_bins + 5, size=1000).astype(np.int32)
    payload = rng.standard_normal((1000, 7)).astype(np.float32)
    ref = _ref(idx, payload, n_bins)
    for method in ("scatter", "sort"):
        acc = scatter_accumulate(jnp.asarray(idx), jnp.asarray(payload), n_bins, method)
        np.testing.assert_allclose(np.asarray(acc), ref, rtol=1e-5, atol=1e-5)


def test_all_one_bin_and_empty_bins():
    idx = jnp.zeros((64,), dtype=jnp.int32)
    payload = jnp.ones((64, 3), dtype=jnp.float32)
    for method in ("scatter", "sort"):
        acc = scatter_accumulate(idx, payload, 8, method)
        np.testing.assert_allclose(np.asarray(acc[0]), 64.0)
        np.testing.assert_allclose(np.asarray(acc[1:]), 0.0)


def test_single_row_per_bin_exact():
    idx = jnp.asarray([3, 1, 4, 0], dtype=jnp.int32)
    payload = jnp.asarray([[1.0], [2.0], [3.0], [4.0]], dtype=jnp.float32)
    for method in ("scatter", "sort"):
        acc = scatter_accumulate(idx, payload, 5, method)
        np.testing.assert_allclose(
            np.asarray(acc).ravel(), [4.0, 2.0, 0.0, 1.0, 3.0]
        )
