"""Benchmark harness — prints ONE JSON line with the north-star metric.

Metric (BASELINE.json): rays/s on one device, forward+backward (full voxel
gradients), 256^3 volume at 1080p, pixel gradients validated against the
per-ray reference integrator (ops/integrate.render_rays_sliced — the same
quadrature the production slice-sweep path computes, expressed as a
per-ray gather march).

vs_baseline: the reference (Raspy-Py/VolumetricRenderer) publishes no
numbers (README.md:15-21; BASELINE.json "published": {}). Its structural
ceiling is the vsync-capped FIFO present mode (VulkanSwapchain.cpp:194-208)
at 1280x720 (VulkanContext.cpp:24): 1280*720*60 = 55.3M rays/s —
*forward-only, no gradients*. vs_baseline = our fwd+bwd rays/s divided by
that forward-only ceiling, so 1.0 means we match the reference's best-case
display throughput while also computing voxel gradients it cannot.

Method: scene setup is jitted; each timed phase is compiled first (its
compile seconds are reported apart) and then timed on the host clock
around calls that end in block_until_ready. The run needs a GPU and fails
without one; every result names the device and the card's power limit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from volumetricrenderer_tpu.config import (CameraConfig, MediumConfig,
                                           RenderConfig)
from volumetricrenderer_tpu.models.scene import cloud_volume
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import render_rays_sliced
from volumetricrenderer_tpu.ops.sweep import (_sweep_base, base_rays,
                                              plan_sweep, sweep_render)

REFERENCE_RAYS_PER_S = 1280 * 720 * 60.0  # fwd-only vsync ceiling, see above

# Smoke-test overrides (the driver runs the defaults).
VOLUME = int(os.environ.get("VOLT_BENCH_VOLUME", 256))
WIDTH = int(os.environ.get("VOLT_BENCH_WIDTH", 1920))
HEIGHT = int(os.environ.get("VOLT_BENCH_HEIGHT", 1080))
ITERS = int(os.environ.get("VOLT_BENCH_ITERS", 10))

# Published peaks by jax device_kind. Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM part, dense rates (no sparsity), at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_peaks(device):
    """The peak table entry of a GPU device; an unknown card or a device
    that is not a GPU is an error, never a default."""
    if device.platform != "gpu":
        raise ValueError(f"no GPU: device platform is {device.platform!r}")
    if device.device_kind not in PEAKS:
        raise KeyError(f"no peak table entry for {device.device_kind!r}")
    return PEAKS[device.device_kind]


def validate_gradients():
    """Voxel gradients of the sweep vs the per-ray reference integrator on
    a small config (same math at full scale; small keeps the oracle's
    gather march affordable)."""
    import numpy as np
    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=48, height=32))
    grid = cloud_volume(24, seed=7)
    plan = plan_sweep(cam, grid.shape, cfg)
    plan_base = dataclasses.replace(plan, identity_warp=True)
    o, d = base_rays(plan)

    def loss_sweep(g):
        return jnp.sum(sweep_render(g, plan_base, cfg, medium)[..., :3] ** 2)

    def loss_oracle(g):
        img = render_rays_sliced(g, o, d, plan, cfg, medium)
        return jnp.sum(img[..., :3] ** 2)

    with jax.default_matmul_precision("highest"):
        g1 = np.asarray(jax.jit(jax.grad(loss_sweep))(grid))
        g2 = np.asarray(jax.jit(jax.grad(loss_oracle))(grid))
    scale = float(np.abs(g2).max())
    ok = np.allclose(g1, g2, rtol=1e-3, atol=1e-3 * scale)
    err = float(np.abs(g1 - g2).max())
    log(f"grad check: allclose={ok} max_abs_err={err:.3e} scale={scale:.3e}")
    return bool(ok)


def make_fwdbwd(plan, cfg, medium):
    def frame_loss(g):
        return jnp.sum(sweep_render(g, plan, cfg, medium)[..., :3] ** 2)

    return jax.value_and_grad(frame_loss)


def time_phase(label, fn, *args):
    from volumetricrenderer_tpu.utils.clock import compile_and_time
    _, _, compile_s, per_call = compile_and_time(fn, *args, iters=ITERS)
    log(f"{label}: compile {compile_s:.1f}s, {per_call*1e3:.3f} ms/frame")
    return per_call


def main():
    from volumetricrenderer_tpu.utils.compile_cache import \
        enable_compile_cache
    from volumetricrenderer_tpu.utils.device import (card_description,
                                                     require_gpu)
    enable_compile_cache()
    devices = require_gpu()
    dev = devices[0]
    peaks = device_peaks(dev)
    card = card_description()
    log(f"device {dev.platform} {dev.device_kind} x{len(devices)}; "
        f"card {card}")
    t_start = time.perf_counter()
    grads_ok = validate_gradients()

    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=WIDTH, height=HEIGHT))

    t0 = time.perf_counter()
    grid = jax.block_until_ready(
        jax.jit(cloud_volume, static_argnums=(0,))(VOLUME, 7))
    plan = plan_sweep(cam, grid.shape, cfg)
    jax.block_until_ready(plan.seglen)
    log(f"setup done in {time.perf_counter()-t0:.1f}s; "
        f"base {plan.base_shape}, slices {plan.slice_z.shape[0]}")

    per_frame = time_phase("f32 fwd+bwd", make_fwdbwd(plan, cfg, medium),
                           grid)
    cfg_bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    per_frame_bf16 = time_phase(
        "bf16 fwd+bwd", make_fwdbwd(plan, cfg_bf16, medium), grid)

    # Early-exit RATES (fraction of base pixels saturated at frame end)
    # at the flagship density and on a dense medium variant.
    @jax.jit
    def exit_rate(g, med_density):
        med = dataclasses.replace(medium, density=1.0)
        gperm = jnp.transpose(g, plan.perm) * med_density
        maps = _sweep_base(gperm, None, plan.slice_z, plan.v_grid,
                           plan.u_grid, plan.seglen, plan, cfg, med,
                           None, None)
        return jnp.mean((maps[1] <= cfg.early_stop_transmittance)
                        .astype(jnp.float32))
    rate_flagship = float(exit_rate(grid, jnp.float32(medium.density)))
    rate_dense = float(exit_rate(grid, jnp.float32(200.0)))

    Hb, Wb = plan.base_shape
    rays_per_s = WIDTH * HEIGHT / per_frame
    print(json.dumps({
        "metric": "rays/s fwd+bwd at 256^3/1080p, one device",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / REFERENCE_RAYS_PER_S,
        "grad_allclose_vs_reference": grads_ok,
        "ms_per_frame_fwd_bwd": per_frame * 1e3,
        "ms_per_frame_bf16": per_frame_bf16 * 1e3,
        "bf16_speedup": per_frame / per_frame_bf16,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
        "card": card,
        "peaks": peaks,
        "early_exit_rate_flagship": rate_flagship,
        "early_exit_rate_dense": rate_dense,
        "base_shape": [int(Hb), int(Wb)],
        "bench_total_s": time.perf_counter() - t_start,
    }))


if __name__ == "__main__":
    main()
