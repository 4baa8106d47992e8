"""Slice-sweep renderer (ops/sweep.py) vs the gather-based sliced oracle
(ops/integrate.render_rays_sliced) — the matmul reformulation must compute
the same integral as per-ray marching, including gradients.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumetricrenderer_tpu.config import (CameraConfig, LightConfig,
                                           MediumConfig, RenderConfig)
from volumetricrenderer_tpu.ops.camera import camera_rays, make_camera
from volumetricrenderer_tpu.ops.integrate import (render_rays,
                                                  render_rays_sliced)
from volumetricrenderer_tpu.ops.resample import (linear_resample_matrix,
                                                 sample_bilinear_2d)
from volumetricrenderer_tpu.ops.sampling import sample_trilinear
from volumetricrenderer_tpu.ops.sweep import (base_rays, plan_sweep,
                                              sweep_render)


def smooth_volume(size, channels=None, seed=0):
    """Low-frequency separable test volume in [0,1]."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(0, 2 * np.pi, size),) * 3,
                          indexing="ij")
    v = 0.5 + 0.25 * np.sin(x + rng.normal()) * np.cos(
        y + rng.normal()) + 0.2 * np.sin(z + rng.normal())
    v = np.clip(v, 0.0, 1.0)
    if channels:
        v = np.stack([np.clip(v * (0.5 + 0.5 * c / channels) + 0.1 * c, 0, 1)
                      for c in range(channels)], axis=-1)
    return jnp.asarray(v, jnp.float32)


def identity_plan(plan):
    """Plan variant that skips the screen warp (returns the base image)."""
    return dataclasses.replace(plan, identity_warp=True)


CAMERAS = {
    "diag-z": CameraConfig(eye=(1.5, 1.2, 3.2), width=24, height=16),
    "diag-x": CameraConfig(eye=(3.2, 1.2, 1.5), width=24, height=16),
    "diag-y": CameraConfig(eye=(0.8, -3.0, 0.9), width=24, height=16),
    "corner": CameraConfig(eye=(3.0, 3.0, 3.0), width=24, height=16),
    # One eye per dominant sweep axis and sign: (axis, sign) in the name.
    "x-neg": CameraConfig(eye=(3.0, 0.4, 0.3), width=24, height=16),
    "x-pos": CameraConfig(eye=(-3.0, 0.4, 0.3), width=24, height=16),
    "y-neg": CameraConfig(eye=(0.3, 3.0, 0.4), width=24, height=16),
    "z-neg": CameraConfig(eye=(0.4, 0.3, 3.0), width=24, height=16),
    "z-pos": CameraConfig(eye=(0.4, 0.3, -3.0), width=24, height=16),
}
AXIS_SIGN = {"x-neg": (0, -1), "x-pos": (0, 1), "y-neg": (1, -1),
             "z-neg": (2, -1), "z-pos": (2, 1)}


def test_resample_matrix_matches_trilinear():
    line = jnp.asarray(np.random.default_rng(0).random(16), jnp.float32)
    grid = line[None, None, :]  # (1, 1, 16): x-varying
    u01 = jnp.asarray(np.linspace(-0.4, 1.4, 37), jnp.float32)
    for mode in ("mirror", "clamp", "wrap"):
        W = linear_resample_matrix(u01, 16, mode)
        got = W @ line
        coords = jnp.stack([u01, jnp.full_like(u01, 0.5),
                            jnp.full_like(u01, 0.5)], axis=-1)
        want = sample_trilinear(grid, coords, mode)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resample_matrix_rows_sum_to_one():
    W = linear_resample_matrix(jnp.linspace(0.1, 0.9, 20), 8, "mirror")
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)


def test_sample_bilinear_2d_exact_at_centers():
    img = jnp.asarray(np.random.default_rng(1).random((6, 9)), jnp.float32)
    rows = (jnp.arange(6, dtype=jnp.float32) + 0.5) / 6
    cols = (jnp.arange(9, dtype=jnp.float32) + 0.5) / 9
    r, c = jnp.meshgrid(rows, cols, indexing="ij")
    np.testing.assert_allclose(sample_bilinear_2d(img, r, c), img, atol=1e-6)


@pytest.mark.parametrize("cam_name", sorted(CAMERAS))
@pytest.mark.parametrize("emission", [False, True])
def test_sweep_base_matches_sliced_oracle(cam_name, emission):
    """The sweep's base image == per-ray sliced march on the base rays,
    for every dominant axis and both compositing modes."""
    grid = smooth_volume(12)
    cfg = RenderConfig(emission=emission)
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CAMERAS[cam_name])
    plan = plan_sweep(cam, grid.shape, cfg)

    got = sweep_render(grid, identity_plan(plan), cfg, medium)
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sweep_full_render_close_to_oracle_pixels():
    """End-to-end (with the screen warp) vs the oracle on the actual pixel
    rays: agreement up to base-grid interpolation error."""
    grid = smooth_volume(16)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CameraConfig(eye=(2.4, 1.8, 2.9), width=48, height=32))
    plan = plan_sweep(cam, grid.shape, cfg, supersample=3.0)

    got = sweep_render(grid, plan, cfg, medium)
    o, d = camera_rays(cam)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium)
    err = np.abs(np.asarray(got - want))
    # Interior agreement is tight; the base->pixel bilinear warp blurs the
    # hard box-silhouette discontinuity over ~1 base texel, so the max
    # (edge pixels only) is bounded loosely.
    # (At 48x32, silhouette pixels are ~10% of the image; at production
    # resolutions the p99 bound tightens by an order of magnitude.)
    assert err.mean() < 4e-3, err.mean()
    assert np.percentile(err, 99) < 5e-2, np.percentile(err, 99)
    assert err.max() < 0.15, err.max()


def test_sliced_converges_to_fixed_quadrature():
    """Both quadratures approximate the same integral: with a smooth volume
    and fine stepping they agree to discretization error."""
    grid = smooth_volume(16)
    medium = MediumConfig(combine="single", density=2.0)
    cam = make_camera(CameraConfig(eye=(0.0, 0.2, 3.5), width=16, height=12))
    o, d = camera_rays(cam)

    cfg_fixed = RenderConfig(emission=True, max_steps=512,
                             step_size=4.0 / 512.0)
    want = render_rays(grid, o, d, cfg_fixed, medium)

    cfg = RenderConfig(emission=True)
    plan = plan_sweep(cam, grid.shape, cfg, n_slices=256)
    got = render_rays_sliced(grid, o, d, plan, cfg, medium)
    err = np.abs(np.asarray(got - want))
    assert err.max() < 3e-2, err.max()


def test_sweep_gradients_match_oracle():
    """Voxel gradients through the matmul sweep == gradients through the
    gather oracle (the whole point: backward = transposed matmuls)."""
    grid = smooth_volume(8)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CAMERAS["corner"])
    plan = plan_sweep(cam, grid.shape, cfg)
    o, d = base_rays(plan)

    def loss_sweep(g):
        img = sweep_render(g, identity_plan(plan), cfg, medium)
        return jnp.sum(img[..., :3] ** 2)

    def loss_oracle(g):
        img = render_rays_sliced(g, o, d, plan, cfg, medium)
        return jnp.sum(img[..., :3] ** 2)

    g1 = jax.grad(loss_sweep)(grid)
    g2 = jax.grad(loss_oracle)(grid)
    np.testing.assert_allclose(g1, g2, rtol=2e-4, atol=1e-4)
    assert float(jnp.abs(g1).max()) > 0.0  # gradients actually flow


def test_warp_custom_vjp_exact():
    """The block-banded matmul adjoint of the screen warp == the true
    transpose (what plain autodiff-of-gather would produce)."""
    from volumetricrenderer_tpu.ops.sweep import (_in01, warp_base_to_pixels)
    grid = smooth_volume(10)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CameraConfig(eye=(2.2, 2.8, 2.4), width=40, height=24))
    plan = plan_sweep(cam, grid.shape, cfg)

    base = jnp.asarray(
        np.random.default_rng(3).random(plan.base_shape + (4,)), jnp.float32)

    def loss_custom(b):
        out = warp_base_to_pixels(b, plan, miss=(0.0, 0.0, 0.0, 1.0))
        return jnp.sum(out ** 2)

    def loss_autodiff(b):
        out = sample_bilinear_2d(b, plan.warp_rows01, plan.warp_cols01,
                                 "clamp")
        inr = (_in01(plan.warp_rows01) & _in01(plan.warp_cols01))[..., None]
        out = jnp.where(inr, out, jnp.asarray((0.0, 0.0, 0.0, 1.0)))
        return jnp.sum(out ** 2)

    np.testing.assert_allclose(loss_custom(base), loss_autodiff(base),
                               rtol=1e-6)
    g1 = jax.grad(loss_custom)(base)
    g2 = jax.grad(loss_autodiff)(base)
    np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-5)

    # And end to end: grid gradients through the warped render match the
    # oracle's pixel-ray gradients up to interpolation error.
    o, d = camera_rays(cam)

    def loss_sweep(g):
        return jnp.sum(sweep_render(g, plan, cfg, medium)[..., :3] ** 2)

    def loss_oracle(g):
        img = render_rays_sliced(g, o, d, plan, cfg, medium)
        return jnp.sum(img[..., :3] ** 2)

    gs = np.asarray(jax.grad(loss_sweep)(grid))
    go = np.asarray(jax.grad(loss_oracle)(grid))
    # Pointwise max differs by base-grid discretization at silhouettes
    # (tiny 24px test image); direction and bulk magnitude must agree.
    cos = (gs * go).sum() / (np.linalg.norm(gs) * np.linalg.norm(go))
    assert cos > 0.99, cos
    assert np.abs(gs - go).mean() / np.abs(go).max() < 0.05


def test_sweep_reference_combine_with_scroll():
    """4-channel reference combine (frag.glsl:63-71 semantics) with
    animated scroll, via layer-lerp + per-channel resample matrices."""
    from volumetricrenderer_tpu.ops.integrate import reference_media_scroll
    grid = smooth_volume(10, channels=4)
    cfg = RenderConfig()
    medium = MediumConfig()  # reference combine
    scroll = reference_media_scroll(1.7)
    cam = make_camera(CAMERAS["corner"])
    plan = plan_sweep(cam, grid.shape, cfg)

    got = sweep_render(grid, identity_plan(plan), cfg, medium, scroll=scroll)
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium, scroll=scroll)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_sweep_camera_inside_box():
    """Slices behind the eye are masked; no NaNs, matches the oracle."""
    grid = smooth_volume(12)
    cfg = RenderConfig(emission=True)
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CameraConfig(eye=(0.1, 0.0, 0.4), center=(0, 0, -3),
                                   width=16, height=12))
    plan = plan_sweep(cam, grid.shape, cfg)
    got = sweep_render(grid, identity_plan(plan), cfg, medium)
    assert np.isfinite(np.asarray(got)).all()
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sweep_rejects_degenerate_camera():
    """A >90deg-FOV camera whose rays straddle an axis plane has no valid
    sweep axis: plan_sweep must refuse (callers fall back to the gather
    integrator)."""
    grid_shape = (8, 8, 8)
    cfg = RenderConfig()
    cam = make_camera(CameraConfig(eye=(3.0, 0.0, 0.0), fov_y_degrees=175.0,
                                   width=16, height=16))
    with pytest.raises(ValueError):
        plan_sweep(cam, grid_shape, cfg)


def test_sweep_nonuniform_box():
    """Anisotropic AABB: segment lengths and normalization must use the
    per-axis box extents."""
    grid = smooth_volume(12)
    cfg = RenderConfig(emission=True, box_min=(-2.0, -1.0, -0.5),
                       box_max=(2.0, 1.5, 0.5))
    medium = MediumConfig(combine="single", density=4.0)
    cam = make_camera(CAMERAS["corner"])
    plan = plan_sweep(cam, grid.shape, cfg)
    got = sweep_render(grid, identity_plan(plan), cfg, medium)
    o, d = base_rays(plan)
    want = render_rays_sliced(grid, o, d, plan, cfg, medium)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_warp_pixmajor_matches_basemajor():
    """The pixel-major forward warp (disjoint pixel tiles gathering base
    windows) computes the same bilinear operator as the base-major rect
    scan — values at every in-footprint pixel and grid gradients must
    match (the custom-vjp backward is shared, so a forward mismatch
    would silently break gradient exactness)."""
    from volumetricrenderer_tpu.ops import sweep as sw

    grid = smooth_volume(10)
    cfg = RenderConfig(emission=True)
    cam = make_camera(CameraConfig(eye=(2.2, 2.8, 2.4), width=64,
                                   height=40))
    plan = plan_sweep(cam, grid.shape, cfg)
    assert plan.pix_band != (0, 0)  # the plan carries the transposed table

    base = jnp.asarray(
        np.random.default_rng(5).random(plan.base_shape + (2,)),
        jnp.float32)

    def run(mode):
        old = os.environ.get("VOLT_WARP_FWD")
        os.environ["VOLT_WARP_FWD"] = mode
        try:
            jax.clear_caches()
            out = sw.warp_base_to_pixels(base, plan, miss=(0.0, 0.0))
            g = jax.grad(lambda b: jnp.sum(
                sw.warp_base_to_pixels(b, plan, miss=(0.0, 0.0)) ** 2))(
                    base)
            return np.asarray(out), np.asarray(g)
        finally:
            if old is None:
                os.environ.pop("VOLT_WARP_FWD", None)
            else:
                os.environ["VOLT_WARP_FWD"] = old
            jax.clear_caches()

    out_b, g_b = run("base")
    out_p, g_p = run("pix")
    np.testing.assert_allclose(out_b, out_p, atol=1e-5)
    np.testing.assert_allclose(g_b, g_p, atol=1e-5)


def test_with_warp_band_unifies_pix_band():
    """4-tuple band unification grows BOTH rect tables (>= covers stay
    exact) and a 2-tuple leaves pix_band untouched; (0, 0) disables."""
    from volumetricrenderer_tpu.ops.sweep import with_warp_band

    grid = smooth_volume(8)
    cfg = RenderConfig(emission=True)
    cam = make_camera(CameraConfig(eye=(2.5, 2.6, 2.7), width=48,
                                   height=32))
    plan = plan_sweep(cam, grid.shape, cfg)
    br, bc = plan.warp_band
    pr, pc = plan.pix_band
    grown = with_warp_band(plan, (br + 8, bc + 8, pr + 16, pc + 16))
    assert grown.warp_band == (br + 8, bc + 8)
    assert grown.pix_band == (pr + 16, pc + 16)
    # grown cover renders identically
    base = jnp.asarray(
        np.random.default_rng(7).random(plan.base_shape + (2,)),
        jnp.float32)
    from volumetricrenderer_tpu.ops.sweep import warp_base_to_pixels
    np.testing.assert_allclose(
        np.asarray(warp_base_to_pixels(base, plan, miss=(0.0, 0.0))),
        np.asarray(warp_base_to_pixels(base, grown, miss=(0.0, 0.0))),
        atol=1e-6)
    legacy = with_warp_band(plan, (br + 8, bc + 8))
    assert legacy.pix_band == plan.pix_band
    disabled = with_warp_band(plan, (br, bc, 0, 0))
    assert disabled.pix_band == (0, 0)


def test_tap_weights_tent_equals_clipped_two_tap():
    """_tap_weights' tent form == the explicit clipped two-tap one-hot
    construction (incl. out-of-range coords, exact texel centers, and
    window-boundary taps)."""
    from volumetricrenderer_tpu.ops.sweep import _tap_weights

    rng = np.random.default_rng(0)
    for n, off, tile in ((96, 0, 96), (1536, 192, 96), (1536, 1440, 96),
                         (256, 64, 128)):
        q = jnp.asarray(np.concatenate([
            rng.uniform(-0.3, 1.3, 2000),
            (np.arange(n + 2) - 0.5) / n,       # texel centers
            np.arange(n + 2) / n]), jnp.float32)
        p = q * n - 0.5
        i0f = jnp.floor(p)
        f = (p - i0f).astype(jnp.float32)
        i0 = jnp.clip(i0f.astype(jnp.int32), 0, n - 1) - off
        i1 = jnp.clip(i0f.astype(jnp.int32) + 1, 0, n - 1) - off
        iota = jnp.arange(tile, dtype=jnp.int32)[None, :]
        ref = (jnp.where(iota == i0[:, None], (1.0 - f)[:, None], 0.0)
               + jnp.where(iota == i1[:, None], f[:, None], 0.0))
        np.testing.assert_allclose(np.asarray(_tap_weights(q, n, off,
                                                           tile)),
                                   np.asarray(ref), atol=1e-6,
                                   err_msg=f"n={n} off={off}")


def test_plan_signature_has_no_kernel_windows():
    """The jit signature is the plan's static geometry and warp tiling
    only: two cameras with equal geometry share it."""
    from volumetricrenderer_tpu.ops.sweep import plan_signature

    cfg = RenderConfig(emission=True)
    plan = plan_sweep(make_camera(CAMERAS["corner"]), (8, 8, 8), cfg)
    sig = plan_signature(plan)
    assert sig == (plan.axis, plan.sign, plan.perm, plan.base_shape,
                   plan.slice_z.shape[0], plan.warp_band, plan.warp_blk,
                   plan.identity_warp, plan.pix_band, plan.pix_blk)
    assert not any(hasattr(plan, f) for f in
                   ("row_window", "col_window", "scatter_window"))
