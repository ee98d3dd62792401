"""The compile-cache helper (gcslam_tpu/utils/cache.py): JAX_COMPILATION_CACHE_DIR
wins and nothing is set in code; otherwise the cache is <repo>/.jax_cache."""

import os

import jax

from gcslam_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_repo_jax_cache():
    assert cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


def test_env_var_set_means_nothing_set_in_code(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV, str(tmp_path / "from_env"))
    assert cache.enable_compile_cache() == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "from_env").exists()  # JAX creates it, not us


def test_env_var_unset_uses_default_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV, raising=False)
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        assert cache.enable_compile_cache() == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_already_configured_cache_is_kept(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "suite"))
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "suite")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "suite")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
