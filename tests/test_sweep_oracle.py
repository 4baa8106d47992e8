"""The plain slice sweep (ops/sweep._sweep_base via sweep_render) against
the per-ray oracle (ops/integrate.render_rays_sliced) on the base rays,
forward AND voxel gradients, for every configuration the sweep serves:
each dominant axis and sign, emission and absorption, light-volume
shading, the early-stop gate, every address mode, sub-voxel slice counts,
the 4-channel reference combine, and bf16 matmul operands.

The oracle marches each ray with trilinear gathers; the sweep computes the
same sliced quadrature with dense resample matmuls, so at f32 on the CPU
the two agree to summation-order rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumetricrenderer_tpu.config import (CameraConfig, LightConfig,
                                           MediumConfig, NoiseChannelConfig,
                                           RenderConfig, VolumeConfig)
from volumetricrenderer_tpu.models.scene import build_volume
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import (reference_media_scroll,
                                                  render_rays_sliced)
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu.ops.sweep import (_layer_channels, _layer_lerp,
                                              _layer_lerp_stack, _sweep_base,
                                              _channel_offsets, base_rays,
                                              plan_sweep, sweep_render)

from test_sweep import AXIS_SIGN, CAMERAS, identity_plan

D = 16
FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def _grad_close(got, want, rel=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0  # gradients actually flow
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _setup(eye=(3.0, 3.0, 3.0), emission=True, seed=0, density=8.0,
           size=D, channels=0, n_slices=None, **cfg_kw):
    cfg = RenderConfig(emission=emission, quadrature="sliced", **cfg_kw)
    medium = (MediumConfig(combine="reference", density=density)
              if channels else MediumConfig(combine="single",
                                            density=density))
    cam = make_camera(CameraConfig(eye=eye, width=24, height=16))
    shape = (size,) * 3 + ((channels,) if channels else ())
    rng = np.random.default_rng(seed)
    grid = jnp.asarray(rng.uniform(0.2, 1.0, shape), jnp.float32)
    plan = plan_sweep(cam, grid.shape[:3], cfg, n_slices=n_slices)
    return cfg, medium, plan, grid


def _weights(plan, seed=9):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=plan.base_shape + (4,)), jnp.float32)


def _pair(plan, cfg, medium, light=None, scroll=None):
    """(sweep, oracle) base-image renderers of (grid, light_volume)."""
    o, d = base_rays(plan)
    ip = identity_plan(plan)

    def sweep(g, lv=None):
        return sweep_render(g, ip, cfg, medium, light, scroll=scroll,
                            light_volume=lv)

    def oracle(g, lv=None):
        return render_rays_sliced(g, o, d, plan, cfg, medium, light,
                                  scroll=scroll, light_volume=lv)

    return sweep, oracle


def _check_fwd_and_grad(plan, cfg, medium, grid, light=None, scroll=None,
                        lv=None, rel=2e-4):
    sweep, oracle = _pair(plan, cfg, medium, light, scroll)
    np.testing.assert_allclose(np.asarray(sweep(grid, lv)),
                               np.asarray(oracle(grid, lv)), **FWD_TOL)
    w = _weights(plan)
    argnums = (0, 1) if lv is not None else 0
    gs = jax.grad(lambda g, l: jnp.sum(sweep(g, l) * w), argnums)(grid, lv)
    go = jax.grad(lambda g, l: jnp.sum(oracle(g, l) * w), argnums)(grid, lv)
    for a, b in (zip(gs, go) if lv is not None else ((gs, go),)):
        _grad_close(a, b, rel)


@pytest.mark.parametrize("cam_name", sorted(AXIS_SIGN))
def test_plan_axis_sign(cam_name):
    """Each eye of the axis/sign set gets the sweep axis and direction it
    is named for."""
    plan = plan_sweep(make_camera(CAMERAS[cam_name]), (D, D, D),
                      RenderConfig(quadrature="sliced"))
    assert (plan.axis, plan.sign) == AXIS_SIGN[cam_name]


@pytest.mark.parametrize("cam_name", sorted(AXIS_SIGN))
@pytest.mark.parametrize("emission", [True, False])
def test_voxel_grad_vs_oracle(cam_name, emission):
    cfg, medium, plan, grid = _setup(CAMERAS[cam_name].eye, emission,
                                     seed=3)
    sweep, oracle = _pair(plan, cfg, medium)
    w = _weights(plan)
    _grad_close(jax.grad(lambda g: jnp.sum(sweep(g) * w))(grid),
                jax.grad(lambda g: jnp.sum(oracle(g) * w))(grid))


@pytest.mark.parametrize("eye", [(3.0, 0.4, 0.3), (0.4, 0.3, -3.0)])
def test_light_volume_forward_vs_oracle(eye):
    cfg, medium, plan, grid = _setup(eye)
    light = LightConfig(ambient=0.2, shadow_steps=16)
    lv = light_transmittance_volume(grid, light, cfg, medium)
    sweep, oracle = _pair(plan, cfg, medium, light)
    got = np.asarray(sweep(grid, lv))
    np.testing.assert_allclose(got, np.asarray(oracle(grid, lv)), **FWD_TOL)
    # the shading actually changes the image
    assert np.abs(got - np.asarray(sweep(grid))).max() > 1e-3


def test_light_volume_grads_vs_oracle():
    """Gradients to the grid AND to the light volume (an independent
    input here; its own dependence on the grid is plain autodiff)."""
    cfg, medium, plan, grid = _setup((3.0, 0.4, 0.3), seed=5)
    light = LightConfig(ambient=0.2, shadow_steps=16)
    lv = light_transmittance_volume(grid, light, cfg, medium)
    _check_fwd_and_grad(plan, cfg, medium, grid, light=light, lv=lv)


def test_early_stop_gate_vs_oracle():
    """High density saturates rays mid-volume: the live gate zeroes the
    slices behind the exit point in the forward and in the gradient,
    exactly as the oracle's per-ray gate does."""
    cfg, medium, plan, grid = _setup((3.0, 0.4, 0.3), seed=7,
                                     density=500.0)
    _check_fwd_and_grad(plan, cfg, medium, grid)
    sat = np.asarray(sweep_render(grid, identity_plan(plan), cfg,
                                  medium))[..., 3]
    assert (sat > 1.0 - cfg.early_stop_transmittance).any()


@pytest.mark.parametrize("mode", ["wrap", "clamp"])
def test_address_modes_vs_oracle(mode):
    cfg, medium, plan, grid = _setup((3.0, 0.4, 0.3), seed=2,
                                     address_mode=mode)
    _check_fwd_and_grad(plan, cfg, medium, grid)


@pytest.mark.parametrize("eye", [(0.3, 0.4, 3.0), (-3.0, 0.4, 0.3)])
def test_subvoxel_slices_vs_oracle(eye):
    """n_slices != depth (the reference caps its march at 128 steps for
    any volume, frag.glsl:30): forward and gradients."""
    cfg, medium, plan, grid = _setup(eye, seed=4, size=32, n_slices=16)
    assert plan.slice_z.shape[0] == 16
    _check_fwd_and_grad(plan, cfg, medium, grid)


# --- 4-channel reference combine (frag.glsl:63-71) -------------------------

@pytest.mark.parametrize("emission", [False, True])
@pytest.mark.parametrize("t", [0.0, 1.7])
def test_reference_combine_forward_vs_oracle(emission, t):
    cfg, medium, plan, grid = _setup(emission=emission, density=1.0,
                                     channels=4)
    scroll = reference_media_scroll(t) if t else None
    sweep, oracle = _pair(plan, cfg, medium, scroll=scroll)
    np.testing.assert_allclose(np.asarray(sweep(grid)),
                               np.asarray(oracle(grid)), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("eye", [(-3.0, 2.5, 2.0), (2.0, -3.2, 2.4),
                                 (1.5, 2.0, 3.4)])
def test_reference_combine_axes_vs_oracle(eye):
    cfg, medium, plan, grid = _setup(eye, density=1.0, channels=4)
    sweep, oracle = _pair(plan, cfg, medium)
    np.testing.assert_allclose(np.asarray(sweep(grid)),
                               np.asarray(oracle(grid)), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("emission", [False, True])
def test_reference_combine_grads_vs_oracle(emission):
    cfg, medium, plan, grid = _setup(emission=emission, seed=3,
                                     density=1.0, channels=4)
    scroll = reference_media_scroll(0.9)
    sweep, oracle = _pair(plan, cfg, medium, scroll=scroll)
    w = _weights(plan)
    _grad_close(jax.grad(lambda g: jnp.sum(sweep(g) * w))(grid),
                jax.grad(lambda g: jnp.sum(oracle(g) * w))(grid))


def test_reference_combine_light_volume_vs_oracle():
    """Shadowed reference-combine media: light transmittance sampled at
    unscaled coords, forward plus grid and light gradients."""
    cfg, medium, plan, grid = _setup((3.0, 0.4, 0.3), channels=4,
                                     address_mode="mirror")
    light = LightConfig(ambient=0.2, shadow_steps=32)
    scroll = reference_media_scroll(0.7)
    lv = light_transmittance_volume(grid, light, cfg, medium, scroll=scroll)
    _check_fwd_and_grad(plan, cfg, medium, grid, light=light, scroll=scroll,
                        lv=lv)


def test_reference_preset_end_to_end():
    """The reference preset's media (4 noise channels, scroll, mirror
    addressing) through the full render, screen warp included, against
    the oracle on the pixel rays (agreement up to the warp's base-grid
    interpolation)."""
    from volumetricrenderer_tpu.config import get_preset
    from volumetricrenderer_tpu.ops.camera import camera_rays
    p = get_preset("reference")
    grid = build_volume(dataclasses.replace(p.volume, size=16))
    cfg = dataclasses.replace(p.render, quadrature="sliced")
    cam = make_camera(dataclasses.replace(p.camera, width=64, height=36))
    scroll = reference_media_scroll(0.5)
    plan = plan_sweep(cam, grid.shape[:3], cfg, supersample=3.0)
    got = np.asarray(sweep_render(grid, plan, cfg, p.medium, p.light,
                                  scroll=scroll))
    o, d = camera_rays(cam)
    want = np.asarray(render_rays_sliced(grid, o, d, plan, cfg, p.medium,
                                         p.light, scroll=scroll))
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.mean() < 4e-3, err.mean()
    assert np.percentile(err, 99) < 5e-2, np.percentile(err, 99)


# --- bf16 matmul operands ---------------------------------------------------

def _bf16_setup(combine):
    if combine == "reference":
        grid = build_volume(VolumeConfig(size=16, channels=(
            NoiseChannelConfig("perlin", 0.21, 1),
            NoiseChannelConfig("perlin", 0.15, 2),
            NoiseChannelConfig("simplex", 0.18, 3),
            NoiseChannelConfig("cellular", 0.12, 4))))
        medium, scroll = MediumConfig(density=2.0), reference_media_scroll(0.7)
    else:
        from volumetricrenderer_tpu.models.scene import cloud_volume
        grid = cloud_volume(16, seed=7)
        medium, scroll = MediumConfig(combine="single", density=8.0), None
    cam = make_camera(CameraConfig(eye=(2.6, 2.1, 2.9), width=48, height=32))
    plans = {}
    for dt in ("float32", "bfloat16"):
        cfg = RenderConfig(emission=True, quadrature="sliced", dtype=dt)
        plans[dt] = (cfg, plan_sweep(cam, grid.shape[:3], cfg))
    return grid, medium, scroll, plans


def _maps(grid, plan, cfg, medium, scroll):
    perm = plan.perm + ((3,) if grid.ndim == 4 else ())
    return _sweep_base(jnp.transpose(grid, perm), None, plan.slice_z,
                       plan.v_grid, plan.u_grid, plan.seglen, plan, cfg,
                       medium, None, scroll)


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_base_maps_close_to_f32(combine):
    """bf16 resample operands with f32 accumulation and compositing: the
    base maps stay within bf16's ~3 decimal digits of the f32 sweep."""
    grid, medium, scroll, plans = _bf16_setup(combine)
    f32 = _maps(grid, plans["float32"][1], plans["float32"][0], medium,
                scroll)
    b16 = _maps(grid, plans["bfloat16"][1], plans["bfloat16"][0], medium,
                scroll)
    for x, y, n in zip(b16, f32, ("acc", "trans", "wsum", "hit")):
        assert x.dtype == jnp.float32, n
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=2e-2, atol=2e-2, err_msg=n)


@pytest.mark.parametrize("combine", ["single", "reference"])
def test_bf16_grads_close_to_f32(combine):
    grid, medium, scroll, plans = _bf16_setup(combine)

    def grad(dt):
        cfg, plan = plans[dt]

        def loss(g):
            m = _maps(g, plan, cfg, medium, scroll)
            return jnp.sum(m[1] ** 2) + jnp.sum(m[2] ** 2)
        return np.asarray(jax.grad(loss)(grid))

    g32, g16 = grad("float32"), grad("bfloat16")
    assert g16.dtype == np.float32 and np.isfinite(g16).all()
    scale = np.abs(g32).max()
    assert scale > 0
    # bf16 keeps ~3 significant digits per operand; the voxel gradient
    # sums many of them, so hold it to a few per cent of its range.
    assert np.abs(g16 - g32).max() < 5e-2 * scale


# --- the plain-XLA layer helpers the sharded sweep uses ---------------------

@pytest.mark.parametrize("mode", ["mirror", "wrap"])
def test_layer_lerp_stack_matches_layer_lerp(mode):
    g = jnp.asarray(np.random.default_rng(0).random((12, 5, 6)),
                    jnp.float32)
    z = jnp.asarray(np.linspace(-0.05, 1.05, 9), jnp.float32)
    got = _layer_lerp_stack(g, z, mode)
    want = jnp.stack([_layer_lerp(g, zi, 12, mode) for zi in z])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_layer_channels_matches_per_channel_lerp():
    """Scaled + scrolled per-channel k-lerp == _layer_lerp of each channel
    at z * scale_c + scroll offset (what _sigma_general does per slice)."""
    medium = MediumConfig()
    g4 = jnp.asarray(np.random.default_rng(1).random((10, 4, 5, 4)),
                     jnp.float32)
    z = jnp.asarray((np.arange(10) + 0.5) / 10, jnp.float32)
    coord_order = (2, 1, 0)
    scroll = reference_media_scroll(1.3)
    offs = _channel_offsets(medium, scroll, coord_order)
    got = _layer_channels(g4, z, medium, offs, "mirror")
    assert got.shape == (10, 4, 4, 5)
    for c in range(4):
        off_k = (scroll[c] * medium.channel_scroll_weight[c])[coord_order[0]]
        want = jnp.stack([
            _layer_lerp(g4[..., c], zi * medium.channel_coord_scale[c]
                        + off_k, 10, "mirror") for zi in z])
        np.testing.assert_allclose(np.asarray(got[:, c]), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
