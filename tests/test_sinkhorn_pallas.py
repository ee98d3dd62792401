"""The fused Sinkhorn kernel (ops/sinkhorn_pallas.py) must reproduce the XLA
loop in math terms (same iteration, same guards). It runs in the Pallas
interpreter here; chip_smoke.py compiles it for the GPU and compares it
there. Also: the backend-choice rule, as a pure function."""

import numpy as np
import pytest

from gcslam_tpu.utils.xla import jax, jnp
from gcslam_tpu.ops.association import _sinkhorn_unbalanced
from gcslam_tpu.ops.sinkhorn_pallas import resolve_backend, sinkhorn_unbalanced_pallas


def _case(N, K, seed=0, n_hyp=None):
    rng = np.random.default_rng(seed)
    shape = (N, K) if n_hyp is None else (n_hyp, N, K)
    C = rng.uniform(0.0, 5.0, size=shape).astype(np.float32)
    # a third of the rows invalid (zero mass), like masked measurements
    valid = rng.uniform(size=N) > 0.33
    a = valid.astype(np.float32)
    a = a / max(a.sum(), 1e-9)
    b = np.full((K,), 1.0 / K, dtype=np.float32)
    return jnp.asarray(C), jnp.asarray(a), jnp.asarray(b)


@pytest.mark.parametrize("N", [128, 257, 1024, 1536])
def test_matches_xla_loop(N):
    C, a, b = _case(N, 8, seed=N)
    ref = _sinkhorn_unbalanced(C, a, b, 0.05, 1.0, 1.0, 50)
    out = sinkhorn_unbalanced_pallas(C, a, b, 0.05, 1.0, 1.0, 50, interpret=True)
    assert out.shape == (N, 8) and out.dtype == C.dtype
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-7)


def test_matches_xla_loop_under_hypothesis_vmap():
    """Under the K_HYP vmap the kernel gets one program per hypothesis."""
    C, a, b = _case(300, 8, seed=3, n_hyp=4)
    C = C * jnp.asarray([1.0, 0.5, 2.0, 1.5], jnp.float32)[:, None, None]
    ref = jax.vmap(lambda c: _sinkhorn_unbalanced(c, a, b, 0.05, 1.0, 1.0, 50))(C)
    out = jax.jit(jax.vmap(lambda c: sinkhorn_unbalanced_pallas(
        c, a, b, 0.05, 1.0, 1.0, 50, interpret=True)))(C)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-7)
    # the hypotheses really differ
    assert np.abs(np.asarray(out[0] - out[2])).max() > 1e-4


def test_odd_column_count_pads_to_power_of_two():
    C, a, b = _case(200, 6, seed=5)
    ref = _sinkhorn_unbalanced(C, a, b, 0.05, 1.0, 1.0, 50)
    out = sinkhorn_unbalanced_pallas(C, a, b, 0.05, 1.0, 1.0, 50, interpret=True)
    assert out.shape == (200, 6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-7)


def test_zero_mass_rows_stay_zero():
    C, a, b = _case(256, 8, seed=7)
    a = a.at[:100].set(0.0)
    out = sinkhorn_unbalanced_pallas(C, a, b, 0.05, 1.0, 1.0, 50, interpret=True)
    np.testing.assert_allclose(np.asarray(out)[:100], 0.0, atol=0.0)
    assert np.all(np.isfinite(np.asarray(out)))


@pytest.mark.parametrize("platform, dtype, want", [
    ("gpu", jnp.float32, "pallas"),
    ("gpu", jnp.float64, "xla"),
    ("cpu", jnp.float32, "xla"),
    ("cpu", jnp.float64, "xla"),
])
def test_auto_backend_rule(platform, dtype, want):
    assert resolve_backend("auto", platform, dtype) == want
    assert resolve_backend("xla", platform, dtype) == "xla"


def test_forced_kernel_where_it_cannot_run_is_an_error():
    assert resolve_backend("pallas", "gpu", jnp.float32) == "pallas"
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_backend("pallas", "cpu", jnp.float32)
    with pytest.raises(ValueError, match="float32"):
        resolve_backend("pallas", "gpu", jnp.float64)
    with pytest.raises(ValueError):
        resolve_backend("triton", "gpu", jnp.float32)


@pytest.mark.gpu
def test_kernel_compiled_for_gpu_matches_xla_loop(gpu_device):
    """The kernel as Triton compiles it, at the production widths, alone and
    under the K_HYP vmap (the same check chip_smoke.py makes)."""
    import chip_smoke

    with jax.default_device(gpu_device):
        rep = chip_smoke.phase_kernel()
    assert rep["ok"], rep["cases"]
