"""bench.py's device handling: peaks come from one table keyed by
device_kind; an unknown card and a device that is not a GPU are errors,
never a default."""
import types

import pytest

import bench


def _dev(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_h100_peaks_found():
    peaks = bench.device_peaks(_dev("gpu", "NVIDIA H100 80GB HBM3"))
    assert peaks["bf16_flops_per_s"] == 989e12
    assert peaks["tf32_flops_per_s"] == 495e12
    assert peaks["fp32_flops_per_s"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no peak table entry"):
        bench.device_peaks(_dev("gpu", "NVIDIA A100-SXM4-80GB"))


def test_non_gpu_platform_raises():
    with pytest.raises(ValueError, match="no GPU"):
        bench.device_peaks(_dev("cpu", "cpu"))
