"""utils/compile_cache.py: idempotent cache enabling, user-config respect,
and the opt-out env var."""
import importlib

import pytest

jax = pytest.importorskip("jax")


def fresh_module():
    from exp_ldpc_tpu.utils import compile_cache
    importlib.reload(compile_cache)
    return compile_cache


def test_sets_default_dir_once(tmp_path, monkeypatch):
    monkeypatch.delenv("EXP_LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    mod = fresh_module()
    monkeypatch.setattr(mod, "DEFAULT_CACHE_DIR", str(tmp_path / "cc"))
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        mod.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        # idempotent: a second call with a different dir is a no-op
        mod.enable_compilation_cache(str(tmp_path / "other"))
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_respects_existing_user_config(tmp_path, monkeypatch):
    monkeypatch.delenv("EXP_LDPC_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    mod = fresh_module()
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path / "user"))
        mod.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "user")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_opt_out_env(monkeypatch, tmp_path):
    monkeypatch.setenv("EXP_LDPC_TPU_NO_COMPILE_CACHE", "1")
    mod = fresh_module()
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        mod.enable_compilation_cache(str(tmp_path / "cc"))
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
