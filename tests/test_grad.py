"""Gradient tests: jax.grad through the integrator vs finite differences,
plus an inverse-render fit smoke test (SURVEY.md section 4 "Gradient")."""
import jax
import jax.numpy as jnp
import numpy as np

from volumetricrenderer_tpu.config import (CameraConfig, LightConfig,
                                           MediumConfig, RenderConfig)
from volumetricrenderer_tpu.fit import fit_grid
from volumetricrenderer_tpu.ops.camera import camera_rays, make_camera
from volumetricrenderer_tpu.ops.integrate import render_rays


def _setup(n=6, size=6, emission=False):
    cam = make_camera(CameraConfig(width=n, height=n))
    o, d = camera_rays(cam)
    grid = jnp.asarray(
        np.random.default_rng(3).uniform(0.2, 0.8, size=(size,) * 3),
        jnp.float32)
    cfg = RenderConfig(max_steps=16, step_size=4.0 / 16.0, emission=emission,
                       early_stop_transmittance=0.0)
    med = MediumConfig(combine="single", density=2.0)
    return grid, o, d, cfg, med


def test_grad_matches_finite_differences_absorption():
    grid, o, d, cfg, med = _setup()

    def loss(g):
        img = render_rays(g, o, d, cfg, med)
        return jnp.sum(img[..., 0])

    g = jax.grad(loss)(grid)
    gn = np.asarray(g, np.float64)
    rng = np.random.default_rng(7)
    eps = 1e-3
    # check 10 random voxels by central differences
    idxs = rng.integers(0, grid.shape[0], size=(10, 3))
    base = np.asarray(grid, np.float64)
    for (i, j, k) in idxs:
        gp = jnp.asarray(base).at[i, j, k].add(eps)
        gm = jnp.asarray(base).at[i, j, k].add(-eps)
        fd = (float(loss(gp)) - float(loss(gm))) / (2 * eps)
        np.testing.assert_allclose(gn[i, j, k], fd, rtol=5e-2, atol=2e-3)


def test_grad_matches_finite_differences_emission():
    grid, o, d, cfg, med = _setup(emission=True)
    light = LightConfig()

    def loss(g):
        img = render_rays(g, o, d, cfg, med, light)
        return jnp.sum(img[..., :3])

    g = jax.grad(loss)(grid)
    gn = np.asarray(g, np.float64)
    rng = np.random.default_rng(11)
    eps = 1e-3
    idxs = rng.integers(0, grid.shape[0], size=(8, 3))
    base = np.asarray(grid, np.float64)
    for (i, j, k) in idxs:
        gp = jnp.asarray(base).at[i, j, k].add(eps)
        gm = jnp.asarray(base).at[i, j, k].add(-eps)
        fd = (float(loss(gp)) - float(loss(gm))) / (2 * eps)
        np.testing.assert_allclose(gn[i, j, k], fd, rtol=5e-2, atol=2e-3)


def test_fit_recovers_target():
    # Render a target from a known grid, fit from scratch: loss must drop
    # by >10x — the inverse-render demo in miniature.
    size, n = 8, 24
    cam = make_camera(CameraConfig(width=n, height=n))
    o, d = camera_rays(cam)
    cfg = RenderConfig(max_steps=16, step_size=4.0 / 16.0, emission=True)
    med = MediumConfig(combine="single", density=4.0)
    true_grid = jnp.asarray(
        np.random.default_rng(5).uniform(0.0, 1.0, size=(size,) * 3),
        jnp.float32)
    target = render_rays(true_grid, o, d, cfg, med, LightConfig())[..., :3]

    res = fit_grid(target, cam, cfg, med, LightConfig(), grid_size=size,
                   steps=60, learning_rate=5e-2)
    assert res.losses[-1] < res.losses[0] * 0.1
    assert np.all(np.isfinite(np.asarray(res.grid)))


def test_train_step_grad_matches_grad_only():
    """The sweep's voxel gradient inside a jitted optimizer step that also
    returns the updated grid (value_and_grad + Adam + clip) equals the
    gradient of a grad-only jit of the same loss — the compilation
    context that once corrupted the gradient through the sweep's input
    transpose on another backend."""
    import optax
    from volumetricrenderer_tpu.ops.sweep import plan_sweep, sweep_render

    cfg = RenderConfig(emission=True, quadrature="sliced")
    med = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(eye=(2.6, 2.1, 2.9), width=24,
                                   height=16))
    grid = jnp.asarray(
        np.random.default_rng(2).uniform(0.2, 1.0, (8, 8, 8)), jnp.float32)
    plan = plan_sweep(cam, grid.shape, cfg)
    target = jnp.full((16, 24, 3), 0.3, jnp.float32)

    def loss(g):
        img = sweep_render(g, plan, cfg, med)
        return jnp.mean((img[..., :3] - target) ** 2)

    opt = optax.adam(1e-2)

    @jax.jit
    def step(x, s):
        lv, gr = jax.value_and_grad(loss)(x)
        u, s = opt.update(gr, s, x)
        return jnp.clip(optax.apply_updates(x, u), 0.0, 1.0), s, lv, gr

    _, _, _, gr = step(grid, opt.init(grid))
    want = jax.jit(jax.grad(loss))(grid)
    np.testing.assert_allclose(np.asarray(gr), np.asarray(want),
                               rtol=1e-6, atol=1e-9)
    assert float(jnp.abs(want).max()) > 0
