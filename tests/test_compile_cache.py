"""The persistent compile cache lands where JAX_COMPILATION_CACHE_DIR says,
else at one fixed path inside the checkout (utils/compile_cache.py)."""
import os

import jax

from volumetricrenderer_tpu.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_set_is_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_env_set_changes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_unset_uses_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_same_path_on_every_call(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    _record_updates(monkeypatch)
    paths = {compile_cache.enable_compile_cache() for _ in range(3)}
    assert paths == {compile_cache.DEFAULT_DIR}
