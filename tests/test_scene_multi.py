"""Multi-volume scene tests (BASELINE config 3 as specified: cloud + smoke
as TWO grids with per-volume world transforms — the reference's per-object
transform analogue, TestMain.cpp:230 + frag.glsl:36-37)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volumetricrenderer_tpu.config import (CameraConfig, MediumConfig,
                                           RenderConfig)
from volumetricrenderer_tpu.models.scene import (Volume, bake_scene,
                                                 cloud_volume, config3_scene,
                                                 smoke_volume, translate_w2l)
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import sample_sigma, scene_sigma
from volumetricrenderer_tpu.render import render_scene

CFG = RenderConfig(emission=True, quadrature="sliced")
MED = MediumConfig(combine="single", density=8.0)


def test_scene_sigma_identity_matches_single():
    g = cloud_volume(8, seed=3)
    pos = jnp.asarray(np.random.default_rng(0).random((40, 3)), jnp.float32)
    s_scene = scene_sigma([Volume(g)], pos, CFG, MED)
    s_single = sample_sigma(g, pos, MED, None, CFG.address_mode)
    np.testing.assert_allclose(np.asarray(s_scene), np.asarray(s_single),
                               rtol=1e-6)


def test_scene_sigma_translation():
    """A translated volume samples at world - t, zero outside its box."""
    g = cloud_volume(8, seed=3)
    t = (0.5, 0.0, 0.0)  # model moves volume +x by 0.5 world units
    vol = Volume(g, translate_w2l(*t))
    pos = jnp.asarray([[0.75, 0.5, 0.5],   # inside: local x = 0.5world-0.5
                       [0.05, 0.5, 0.5]],  # outside: local x < box
                      jnp.float32)
    s = scene_sigma([vol], pos, CFG, MED)
    # shifted sample: world x = 0.5 -> local x = 0.0 -> pos01 x = 0.25
    expect = sample_sigma(g, jnp.asarray([[0.5, 0.5, 0.5]], jnp.float32),
                          MED, None, CFG.address_mode)
    np.testing.assert_allclose(float(s[0]), float(expect[0]), rtol=1e-5)
    assert float(s[1]) == 0.0


def test_scene_sigma_overlap_adds():
    g1 = cloud_volume(8, seed=3)
    g2 = smoke_volume(8, seed=5)
    pos = jnp.asarray(np.random.default_rng(1).random((20, 3)), jnp.float32)
    s = scene_sigma([Volume(g1), Volume(g2)], pos, CFG, MED)
    s1 = scene_sigma([Volume(g1)], pos, CFG, MED)
    s2 = scene_sigma([Volume(g2)], pos, CFG, MED)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s1 + s2), rtol=1e-5)


def test_bake_voxel_aligned_translation_exact():
    """Baking a volume translated by exactly k voxels reproduces the
    shifted voxels bit-for-bit (trilinear at lattice points is the
    identity), zero-filled where the volume left the box."""
    n = 8
    g = cloud_volume(n, seed=3)
    shift = 2  # voxels along +x
    t = shift * 2.0 / n
    baked = np.asarray(bake_scene([Volume(g, translate_w2l(t, 0, 0))], n,
                                  CFG))
    expect = np.zeros_like(baked)
    expect[:, :, shift:] = np.asarray(g)[:, :, :-shift]
    np.testing.assert_allclose(baked, expect, atol=1e-6)


def test_render_scene_sweep_matches_oracle():
    """End-to-end: two-volume scene, sweep path (bake + slice sweep) vs the
    per-ray sliced oracle with exact per-volume fields. Voxel-aligned
    translations keep the bake exact on the lattice; volumes with zero
    boundary density (radial falloff) avoid the one-voxel smear the bake
    applies at a hard volume edge (documented in bake_scene)."""
    n = 16
    scene = [
        Volume(cloud_volume(n, seed=3), translate_w2l(0.0, 0.0, 4 * 2.0 / n)),
        Volume(cloud_volume(n, seed=5),
               translate_w2l(0.0, 2 * 2.0 / n, -2 * 2.0 / n)),
    ]
    cam = make_camera(CameraConfig(width=48, height=32))
    img_sweep = render_scene(scene, cam, CFG, MED, backend="sweep",
                             bake_size=n)
    img_oracle = render_scene(scene, cam, CFG, MED, backend="reference",
                              bake_size=n)
    err = np.abs(np.asarray(img_sweep) - np.asarray(img_oracle))
    # same tolerance regime as the single-volume sweep-vs-oracle tests
    # (base-grid resampling approximation at this tiny resolution)
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 5e-2, err.max()


def test_render_scene_gradients():
    """Full backward through the multi-volume sweep path: d(loss)/d(grids)
    exists and matches the oracle path (config 3's inverse-render demand)."""
    n = 8
    g1 = cloud_volume(n, seed=3)
    g2 = cloud_volume(n, seed=5)
    cam = make_camera(CameraConfig(width=16, height=12))
    w1 = translate_w2l(0.0, 0.0, 2 * 2.0 / n)

    def loss(backend, ga, gb):
        scene = [Volume(ga, w1), Volume(gb)]
        img = render_scene(scene, cam, CFG, MED, backend=backend,
                           bake_size=n)
        return jnp.sum(img[..., :3] ** 2)

    with jax.default_matmul_precision("highest"):
        gs = jax.grad(lambda a, b: loss("sweep", a, b), argnums=(0, 1))(
            g1, g2)
        go = jax.grad(lambda a, b: loss("reference", a, b), argnums=(0, 1))(
            g1, g2)
    for a, b in zip(gs, go):
        a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        assert cos > 0.99, cos
        assert np.abs(a - b).mean() / (np.abs(b).max() + 1e-12) < 0.05


def test_config3_preset_uses_scene():
    from volumetricrenderer_tpu.config import get_preset
    from volumetricrenderer_tpu.render import render_preset
    p = get_preset("config3")
    assert p.scene == "config3_scene"
    small = dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=8),
        camera=dataclasses.replace(p.camera, width=16, height=12))
    img = render_preset(small)
    assert img.shape == (12, 16, 4)
    assert bool(jnp.all(jnp.isfinite(img)))
