"""Public rendering API — the `Renderer` equivalent.

The reference's Renderer (VulkanRenderer.h:58-100) is an imperative frame
engine: Init, AddRenderPass, per-frame Enqueue/Begin/End over a swapchain.
The equivalent here is functional: `render(...)` is a jitted pure
function from (grid, camera, configs, time) to an RGBA image; "frames in
flight" fall out of XLA's async dispatch (launch N renders back to back and
block on results), and the swapchain is `utils.image.write_png`.

Quadratures and backends (RenderConfig.quadrature selects the math,
`backend` selects the implementation):

  quadrature "sliced" (default for the staged BASELINE configs):
    * "sweep":     slice-sweep (ops/sweep.py) — banded-matmul
                   resampling, no gathers. The fast path.
    * "reference": per-ray jnp oracle (ops/integrate.render_rays_sliced).
  quadrature "fixed" (frag.glsl:42-46 step-parity):
    * "reference": the jnp scan integrator (ops/integrate.render_rays).
  backend "auto" picks sweep for sliced (falling back to fixed/reference
  if the camera geometry does not admit a sweep axis) and reference for
  fixed.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .config import (LightConfig, MediumConfig, Preset, RenderConfig)
from .models.scene import Volume, bake_scene, build_volume
from .ops.camera import Camera, camera_rays, make_camera
from .ops.integrate import (reference_media_scroll, render_rays,
                            render_rays_sliced, scene_sigma)
from .ops.sweep import SweepPlan, plan_sweep, sweep_render

__all__ = ["render", "render_preset", "render_image", "render_scene",
           "prepare_baked_scene", "plan_for"]


def plan_for(camera: Camera, grid_shape, cfg: RenderConfig,
             world_to_local=None, n_slices=None) -> SweepPlan:
    """Build (host-side) the sweep plan for a camera/volume/config triple.
    Callers rendering many frames with a static camera should build the
    plan once and pass it to render_image."""
    return plan_sweep(camera, grid_shape, cfg,
                      world_to_local=world_to_local,
                      supersample=cfg.sweep_supersample,
                      n_slices=n_slices)


def render_image(
    grid,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    world_to_local=None,
    backend: str = "auto",
    plan: Optional[SweepPlan] = None,
    light_volume=None,
):
    """Render one RGBA frame (H, W, 4) from a density grid and camera."""
    if backend not in ("auto", "sweep", "reference"):
        # A typo'd backend must not silently select the per-ray oracle
        # (the slow path the fallback warning below exists for).
        raise ValueError(
            f"unknown backend {backend!r}: expected 'auto', 'sweep', "
            "or 'reference'")
    if (cfg.quadrature == "sliced" and light is not None
            and light.shadow_steps > 0 and light_volume is None
            and cfg.emission):
        # Config-4 shadows: one light-propagation sweep per frame
        # (O(volume) matmuls) instead of a nested march per sample.
        from .ops.lighting import light_transmittance_volume
        light_volume = light_transmittance_volume(grid, light, cfg, medium,
                                                  scroll=scroll)
    if cfg.quadrature == "sliced":
        if plan is None:
            try:
                plan = plan_for(camera, grid.shape, cfg, world_to_local)
            except ValueError as e:
                if backend in ("sweep",):
                    raise
                # Loud fallback: the per-ray gather integrator is a
                # different, slower path — this switch must never be
                # silent.
                from .utils.metrics import get_logger
                get_logger().warning(
                    "no sweep axis for this camera (%s); falling back to "
                    "the per-ray gather integrator — expect a slowdown", e)
                plan = None
        if plan is not None:
            if backend in ("auto", "sweep"):
                return sweep_render(grid, plan, cfg, medium, light,
                                    scroll=scroll, light_volume=light_volume)
            origins, directions = camera_rays(camera)
            return render_rays_sliced(grid, origins, directions, plan, cfg,
                                      medium, light, scroll=scroll,
                                      light_volume=light_volume)
        # No sweep axis (extreme FOV): fall through to the fixed-step path.
    elif backend == "sweep":
        raise ValueError('backend "sweep" requires quadrature "sliced"')
    origins, directions = camera_rays(camera)
    return render_rays(grid, origins, directions, cfg, medium, light,
                       scroll=scroll, world_to_local=world_to_local)


# `render` is the stable public name.
render = render_image


def prepare_baked_scene(volumes, cfg: RenderConfig, medium: MediumConfig,
                        scroll=None, bake_size=None):
    """Bake a multi-volume scene onto one shared grid for the single-grid
    sweep path; returns (grid, medium, scroll) ready for render_image.

    4-channel reference combine (frag.glsl:63-71): each volume's combined
    sigma is first materialized at voxel centers (ops/media.py — the
    scroll folds into the materialization), then the scalar fields bake
    as usual (overlapping sigmas add — independent scatterers) and the
    returned medium is the equivalent single-channel one. Shared by
    render_scene and the animate CLI so one preset renders identically
    through both."""
    import dataclasses as _dc

    volumes = [v if isinstance(v, Volume) else Volume(v) for v in volumes]
    if medium.combine == "reference":
        from .ops.media import materialize_sigma
        volumes = [
            Volume(materialize_sigma(v.grid, medium, scroll,
                                     cfg.address_mode), v.world_to_local)
            for v in volumes]
        medium = _dc.replace(medium, combine="single", sample_scale=1.0)
        scroll = None
    size = bake_size or max(max(v.grid.shape[:3]) for v in volumes)
    return bake_scene(volumes, size, cfg), medium, scroll


def render_scene(
    volumes,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    backend: str = "auto",
    bake_size: Optional[int] = None,
    plan: Optional[SweepPlan] = None,
):
    """Render a multi-volume scene: N density grids, each with its own
    world transform (models.scene.Volume), composited as independent
    scatterers (densities add where volumes overlap).

    The reference's analogue is its single transformed cube
    (TestMain.cpp:230 + frag.glsl:36-37); BASELINE config 3 specifies a
    cloud + smoke two-volume scene.

    Paths: backend "auto"/"sweep" bakes the scene onto one shared grid
    (models.scene.bake_scene — once per scene, exact for voxel-aligned
    translations) and runs the slice-sweep per frame; backend
    "reference" marches rays against the exact per-volume fields
    (ops/integrate.scene_sigma — arbitrary affines, no bake error)."""
    volumes = [v if isinstance(v, Volume) else Volume(v) for v in volumes]
    if medium.combine not in ("single", "reference"):
        raise ValueError(f"unknown combine mode {medium.combine!r}")
    if backend in ("auto", "sweep") and cfg.quadrature == "sliced":
        grid, bake_medium, scroll = prepare_baked_scene(
            volumes, cfg, medium, scroll=scroll, bake_size=bake_size)
        return render_image(grid, camera, cfg, bake_medium, light,
                            scroll=scroll, backend=backend, plan=plan)
    origins, directions = camera_rays(camera)
    sigma = lambda pos: scene_sigma(volumes, pos, cfg, medium, scroll)
    if cfg.quadrature == "sliced":
        size = bake_size or max(max(v.grid.shape[:3]) for v in volumes)
        if plan is None:
            plan = plan_for(camera, (size,) * 3, cfg)
        return render_rays_sliced(None, origins, directions, plan, cfg,
                                  medium, light, scroll=scroll,
                                  sigma_fn=sigma)
    return render_rays(None, origins, directions, cfg, medium, light,
                       scroll=scroll, sigma_fn=sigma)


def render_preset(preset: Preset, t: float = 0.0, grid=None,
                  backend: str = "auto", plan: Optional[SweepPlan] = None):
    """Render a named BASELINE preset at animation time t (seconds).

    The time parameter drives the media scroll exactly like the demo loop
    (TestMain.cpp:232-238 feeds Clock::Elapsed into MediaScroll)."""
    cam = make_camera(preset.camera)
    if grid is None and preset.scene:
        from .models import scene as scene_mod
        volumes = getattr(scene_mod, preset.scene)(preset.volume.size)
        return render_scene(volumes, cam, preset.render, preset.medium,
                            preset.light, backend=backend, plan=plan)
    if grid is None:
        grid = build_volume(preset.volume)
    n_channels = grid.shape[-1] if grid.ndim == 4 else 1
    scroll = reference_media_scroll(t, n_channels=max(n_channels, 1))
    return render_image(grid, cam, preset.render, preset.medium,
                        preset.light, scroll=scroll, backend=backend,
                        plan=plan)
