"""Device-facing helpers: peak-bandwidth lookup, device memory, the compile
cache rule, and chip_smoke's refusal to run without a GPU."""
import importlib.util
import os
from types import SimpleNamespace

import jax
import pytest

from linkpred_tpu.utils import cache, device, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform, kind="", stats=None):
    return SimpleNamespace(platform=platform, device_kind=kind,
                           memory_stats=lambda: stats)


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA H100 NVL", 3900.0)])
def test_h100_peak(kind, peak):
    assert roofline.device_peak_gbps(_dev("gpu", kind)) == peak


def test_unknown_gpu_peak_raises():
    with pytest.raises(KeyError, match="A100"):
        roofline.device_peak_gbps(_dev("gpu", "NVIDIA A100-SXM4-80GB"))


def test_cpu_has_no_peak():
    assert roofline.device_peak_gbps(_dev("cpu", "cpu")) is None
    out = roofline.roofline_report(10**9, 10.0)     # the test backend: CPU
    assert "frac_of_peak" not in out and out["achieved_gbps_min_model"] == 100


@pytest.fixture
def fake_device(monkeypatch):
    def use(dev):
        monkeypatch.setattr(jax, "devices", lambda *a: [dev])
        device.hbm_bytes.cache_clear()
    yield use
    device.hbm_bytes.cache_clear()


def test_hbm_bytes_gpu_stats(fake_device):
    fake_device(_dev("gpu", "NVIDIA H100 80GB HBM3",
                     {"bytes_limit": 60 << 30, "bytes_in_use": 0}))
    assert device.hbm_bytes() == 60 << 30


def test_hbm_bytes_gpu_without_stats_raises(fake_device):
    fake_device(_dev("gpu", "NVIDIA H100 80GB HBM3", None))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device.hbm_bytes()


def _cache_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    path = cache.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)]
    return path


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _cache_dir(monkeypatch) == str(tmp_path)


def test_compile_cache_fixed_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = _cache_dir(monkeypatch)
    assert path == os.path.join(REPO, ".jax_cache")
    assert _cache_dir(monkeypatch) == path


def test_chip_smoke_refuses_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err
