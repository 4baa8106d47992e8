"""Light-transmittance volume sweep (ops/lighting.py) — closed forms,
direct-march cross-check, and end-to-end shading parity between the
sweep and the per-ray oracle.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from volumetricrenderer_tpu.config import (CameraConfig, LightConfig,
                                           MediumConfig, RenderConfig)
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import render_rays_sliced
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu.ops.sampling import sample_trilinear
from volumetricrenderer_tpu.ops.sweep import base_rays, plan_sweep, sweep_render

from test_sweep import identity_plan, smooth_volume


def test_light_volume_homogeneous_axial():
    """Constant density, light straight up (+z): tau at layer s is exactly
    sigma * dl * (#layers above), so L has a closed form per layer."""
    S = 16
    c = 0.4
    grid = jnp.full((S, S, S), c, jnp.float32)
    cfg = RenderConfig()
    medium = MediumConfig(combine="single", density=2.0, sample_scale=0.5)
    light = LightConfig(direction=(0.0, 0.0, 1.0), shadow_steps=1)

    L = np.asarray(light_transmittance_volume(grid, light, cfg, medium))
    dl = (1.0 / S) * 2.0  # one slice step, box extent 2 along z
    sigma = c * medium.sample_scale
    for s in range(S):
        want = np.exp(-medium.density * sigma * dl * (S - 1 - s))
        np.testing.assert_allclose(L[s], want, rtol=1e-5)


def test_light_volume_matches_direct_march():
    """Oblique light on a smooth volume: the resampling recurrence agrees
    with a brute-force per-voxel march toward the light (both sampling at
    slice-plane crossings) up to compounded-interpolation error."""
    S = 16
    grid = smooth_volume(S)
    cfg = RenderConfig()
    medium = MediumConfig(combine="single", density=4.0, sample_scale=1.0)
    light = LightConfig(direction=(0.3, -0.2, 1.0), shadow_steps=1)

    L = np.asarray(light_transmittance_volume(grid, light, cfg, medium))

    # Direct march: for each voxel center, step slice-by-slice toward the
    # light, trilinear-sampling sigma with zero weight outside the box.
    ld = np.asarray(light.direction, np.float64)
    ld = ld / np.linalg.norm(ld)
    rng = np.array([2.0, 2.0, 2.0])
    w = ld / rng
    dz = 1.0 / S
    step01 = np.array([w[0], w[1], w[2]]) * (dz / abs(w[2]))  # axis = z
    dl = np.linalg.norm(step01 * rng)
    zs, ys, xs = np.meshgrid(*((np.arange(S) + 0.5) / S,) * 3, indexing="ij")
    pos = np.stack([xs, ys, zs], axis=-1)  # (S,S,S,3) xyz
    tau = np.zeros((S, S, S))
    interior = np.ones((S, S, S), bool)  # path never grazes a side wall
    margin = 1.5 / S
    for i in range(1, S):
        p = pos + step01 * i
        inside = ((p >= 0.0) & (p <= 1.0)).all(axis=-1)
        in_z = p[..., 2] <= 1.0
        side_ok = ((p[..., 0] > margin) & (p[..., 0] < 1 - margin)
                   & (p[..., 1] > margin) & (p[..., 1] < 1 - margin))
        interior &= ~in_z | side_ok
        sig = np.asarray(sample_trilinear(
            grid, jnp.asarray(p, jnp.float32), "clamp"))
        tau += np.where(inside, sig, 0.0) * dl
    want = np.exp(-medium.density * tau)

    # Boundary semantics differ by design (the sweep treats outside-box as
    # vacuum with half-texel feathering; the brute-force march masks at
    # sample centers), so compare where the light path stays interior.
    err = np.abs(L - want)[interior]
    assert err.size > S ** 3 // 4  # the mask keeps a meaningful set
    assert err.mean() < 5e-3, err.mean()
    assert err.max() < 8e-2, err.max()


def test_shaded_render_sweep_matches_oracle():
    """sweep_render and the per-ray oracle sample the same light volume:
    shaded images must match exactly (same math, resampled vs gathered)."""
    grid = smooth_volume(12)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=6.0)
    light = LightConfig(direction=(0.4, 0.2, 1.0), ambient=0.2,
                        shadow_steps=1)
    L = light_transmittance_volume(grid, light, cfg, medium)
    cam = make_camera(CameraConfig(eye=(2.5, 2.2, 2.8), width=24, height=16))
    plan = plan_sweep(cam, grid.shape, cfg)

    got = sweep_render(grid, identity_plan(plan), cfg, medium, light,
                       light_volume=L)
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium, light,
                              light_volume=L)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_shadows_only_darken():
    """Shading multiplies in-scatter by [ambient, 1]: a shadowed render is
    pointwise <= the unshadowed one (rgb), alpha unchanged."""
    grid = smooth_volume(12)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=6.0)
    light = LightConfig(direction=(0.5, 0.5, 1.0), ambient=0.1,
                        shadow_steps=1)
    L = light_transmittance_volume(grid, light, cfg, medium)
    cam = make_camera(CameraConfig(eye=(2.5, 2.2, 2.8), width=24, height=16))
    plan = plan_sweep(cam, grid.shape, cfg)

    lit = np.asarray(sweep_render(grid, identity_plan(plan), cfg, medium,
                                  light))
    shaded = np.asarray(sweep_render(grid, identity_plan(plan), cfg, medium,
                                     light, light_volume=L))
    assert (shaded[..., :3] <= lit[..., :3] + 1e-6).all()
    np.testing.assert_allclose(shaded[..., 3], lit[..., 3], atol=1e-6)
    assert np.isfinite(shaded).all()
    # and the shadows are not trivial (some pixels actually darkened)
    assert (lit[..., :3] - shaded[..., :3]).max() > 1e-3


def test_light_volume_gradients_flow():
    import jax
    grid = smooth_volume(8)
    cfg = RenderConfig()
    medium = MediumConfig(combine="single", density=4.0)
    light = LightConfig(direction=(0.2, 0.1, 1.0), shadow_steps=1)

    def loss(g):
        return jnp.sum(light_transmittance_volume(g, light, cfg, medium))

    g = jax.grad(loss)(grid)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0
