"""The platform query, the device-memory read and the compile cache."""

from pathlib import Path

import jax
import pytest

import sblas.utils.backend as be


def test_platform_is_cpu_here():
    assert be.platform() == "cpu"


def test_platform_refuses_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        be.platform()


def test_device_bytes_limit_unreported_on_cpu():
    assert be.device_bytes_limit() is None


def test_device_bytes_limit_reads_memory_stats(monkeypatch):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 60 << 30, "peak_bytes_in_use": 1}

    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    assert be.device_bytes_limit() == 60 << 30


@pytest.fixture
def config_updates(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return seen


def test_compile_cache_honours_env(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert be.use_compile_cache() == str(tmp_path)
    assert config_updates["jax_compilation_cache_dir"] == str(tmp_path)


def test_compile_cache_default_is_in_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(be.use_compile_cache())
    root = Path(__file__).resolve().parent.parent
    assert path == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text()
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_bench_refuses_cpu(capsys):
    import runpy

    bench = runpy.run_path(str(Path(__file__).resolve().parent.parent
                               / "bench.py"))
    assert bench["main"]() == 1
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err
