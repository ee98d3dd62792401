"""Test config: the tests run on the CPU, on an 8-device virtual mesh so the
sharding tests work without several accelerators. The platform is pinned
through jax.config before the first backend init, so a machine whose JAX
would default to a GPU still runs the suite on the CPU (tests that need the
card carry the `gpu` marker and the `gpu_device` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# This box has ONE CPU: XLA's parallel LLVM codegen (default split count 32)
# spawns a thread storm per compile, and with several pytest processes
# compiling at once it segfaulted the CPU compiler three rounds in a row.
# One codegen thread per compile is strictly safer here and not measurably
# slower on a single core.
if "xla_cpu_parallel_codegen_split_count" not in flags:
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

# GCSLAM_TEST_PLATFORMS=cuda,cpu lets the `gpu`-marked tests reach a card.
jax.config.update("jax_platforms", os.environ.get("GCSLAM_TEST_PLATFORMS", "cpu"))

# Persistent compile cache for TESTS: the suite would otherwise spend most
# of its wall-clock recompiling the same small-budget pipelines in every
# fresh per-file process. Tests keep their own directory (never the
# production .jax_cache); where JAX_COMPILATION_CACHE_DIR is set, JAX uses
# that and nothing is set here. GCSLAM_TEST_NO_CACHE=1 opts out.
if os.environ.get("GCSLAM_TEST_NO_CACHE") != "1" and not os.environ.get(
        "JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = os.path.join(os.path.dirname(__file__), ".jax_test_cache")
    os.makedirs(_cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

import gcslam_tpu  # noqa: E402,F401  (enables x64 before any test builds arrays)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables after each test module.

    In one long-lived process the suite accumulates ~100 sizeable XLA CPU
    executables; that accumulation eventually segfaults
    backend_compile_and_load near the end of the suite (rounds 1-2). The
    canonical lane (tests/run_suite.py) isolates per file with fresh
    processes; this fixture protects plain ``pytest tests/`` runs too.
    Module-scoped so jitted functions stay cached WITHIN a file.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where JAX has none.
    Decided here, at run time, never while a module is imported."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (on the card: GCSLAM_TEST_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/test_sinkhorn_pallas.py)")
    return gpus[0]
