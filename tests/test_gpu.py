"""Checks that need the NVIDIA card. Each decides in the `gpu` fixture
whether JAX sees a GPU and skips here, on the CPU. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""
import jax
import pytest


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {dev.platform!r}")
    return dev


@pytest.mark.gpu
def test_peak_table_knows_this_card(gpu):
    import bench
    assert bench.device_peaks(gpu)["bf16_flops_per_s"] > 0


@pytest.mark.gpu
def test_sweep_oracle_parity_small(gpu):
    """chip_smoke.py's parity phase (highest and default matmul precision,
    forward and voxel gradient) at a reduced size."""
    import chip_smoke
    chip_smoke.parity_phase(size=64, fwd_px=(320, 180), grad_px=(160, 90),
                            ref_px=(320, 180), ref_size=64)
