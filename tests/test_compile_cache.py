"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR
says, and otherwise at the fixed in-repo .jax_cache/."""

import os

import jax
import pytest

from astrophotography_tpu.utils.compile_cache import (REPO_CACHE_DIR,
                                                      enable_compile_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_environment(monkeypatch, tmp_path,
                                    restore_cache_config):
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_cache_dir_unset_is_fixed_repo_path(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR
