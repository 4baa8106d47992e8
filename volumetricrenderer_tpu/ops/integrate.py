"""Reference ray-march integrator in pure jnp — the golden oracle.

Replicates the reference's hot loop (shaders/frag.glsl:34-81) as a
`lax.scan` over march steps, vectorized over all rays:

  * box-local ray setup + slab AABB intersect   (frag.glsl:36-39)
  * fixed step size = 4/max_steps, actual step count from slab distance
    (frag.glsl:42-46)
  * per step, per channel: coordinate scale + time scroll offset, trilinear
    3D sample                                     (frag.glsl:66-69)
  * channel combine (s1*s2)*(s3+s4)*scale         (frag.glsl:71)
  * Beer-Lambert 1 - exp(-density * integral)     (frag.glsl:76-79)

Extensions over the reference (per BASELINE.json configs 2-4): front-to-back
emission-absorption compositing with transmittance, a directional light with
optional secondary shadow march, and transmittance early termination (the
reference has none, frag.glsl:57-75 — here it is a masked no-op so shapes
stay static for XLA).

This module is deliberately compiler-friendly rather than hand-tiled: it is
both the correctness oracle for the Pallas kernels and a solid jit path in
its own right (XLA fuses the whole step body; the gathers in
`sample_trilinear` are the only non-fused ops).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import LightConfig, MediumConfig, RenderConfig
from .aabb import intersect_aabb
from .sampling import sample_trilinear

__all__ = [
    "reference_media_scroll",
    "sample_sigma",
    "scene_sigma",
    "render_rays",
    "render_rays_sliced",
    "transform_rays",
]


def reference_media_scroll(t, n_channels=4):
    """Per-channel scroll 3-vectors from elapsed time, modeling the demo's
    MediaScroll matrix (TestMain.cpp:233-238: only the x-row is animated,
    as (-t, 0, 0)). Returns (C, 3) float32."""
    t = jnp.asarray(t, jnp.float32)
    rows = [jnp.stack([-t, jnp.zeros_like(t), jnp.zeros_like(t)])]
    rows += [jnp.zeros(3, jnp.float32)] * (n_channels - 1)
    return jnp.stack(rows)


def transform_rays(origins, directions, world_to_local):
    """Apply the WorldToLocal transform to rays (frag.glsl:36-37 transforms
    camera + fragment positions; transforming origin and direction is
    equivalent and avoids re-normalizing per step). world_to_local: (4,4)."""
    m = jnp.asarray(world_to_local, jnp.float32)
    o = origins @ m[:3, :3].T + m[:3, 3]
    d = directions @ m[:3, :3].T
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def sample_sigma(grid, pos01, medium: MediumConfig, scroll, address_mode):
    """Extinction density at normalized position(s) pos01 (..., 3).

    combine="reference": 4 channels, coords scaled/scrolled per channel,
    sigma = (s1*s2)*(s3+s4)*sample_scale            (frag.glsl:63-71)
    combine="single": channel 0 at pos01, sigma = s0*sample_scale."""
    if medium.combine == "reference":
        if grid.ndim != 4 or grid.shape[-1] < 4:
            raise ValueError("reference combine needs a (D,H,W,4) grid")
        samples = []
        for c in range(4):
            coord = pos01 * medium.channel_coord_scale[c]
            if scroll is not None:
                coord = coord + scroll[c] * medium.channel_scroll_weight[c]
            samples.append(
                sample_trilinear(grid[..., c], coord, address_mode)
            )
        s1, s2, s3, s4 = samples
        return (s1 * s2) * (s3 + s4) * medium.sample_scale
    elif medium.combine == "single":
        g = grid[..., 0] if grid.ndim == 4 else grid
        s = sample_trilinear(g, pos01, address_mode)
        return s * medium.sample_scale
    raise ValueError(f"unknown combine mode {medium.combine!r}")


def scene_sigma(volumes, pos01, cfg: RenderConfig, medium: MediumConfig,
                scroll=None):
    """Summed extinction of a multi-volume scene at shared-box normalized
    positions pos01 (..., 3). Each volume carries its own world_to_local
    (the reference's per-object transform: TestMain.cpp:230 computes
    WorldToLocal = inverse(Model); frag.glsl:36-37 applies it to the ray);
    densities of overlapping volumes add (independent scatterers).
    Positions falling outside a volume's own [0,1] box contribute zero —
    NOT an address-mode repeat (each Volume is a finite object)."""
    box_min = jnp.asarray(cfg.box_min, jnp.float32)
    box_range = jnp.asarray(cfg.box_max, jnp.float32) - box_min
    world = pos01 * box_range + box_min
    total = jnp.zeros(pos01.shape[:-1], jnp.float32)
    for vol in volumes:
        if vol.world_to_local is None:
            p = pos01
        else:
            m = jnp.asarray(vol.world_to_local, jnp.float32)
            local = world @ m[:3, :3].T + m[:3, 3]
            p = (local - box_min) / box_range
        inside = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
        s = sample_sigma(vol.grid, p, medium, scroll, cfg.address_mode)
        total = total + jnp.where(inside, s, 0.0)
    return total


def _light_transmittance(grid, pos01, medium, scroll, cfg: RenderConfig,
                         light: LightConfig, sigma_fn=None):
    """Secondary light-march (BASELINE config 4): march from pos01 towards
    the light, accumulate extinction, return exp(-density * integral)."""
    ldir = jnp.asarray(light.direction, jnp.float32)
    ldir = ldir / jnp.linalg.norm(ldir)
    box_range = jnp.asarray(cfg.box_max, jnp.float32) - jnp.asarray(
        cfg.box_min, jnp.float32)
    step01 = light.shadow_step_size * ldir / box_range

    def body(i, acc):
        p = pos01 + step01 * (i + 1.0)
        inside = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
        if sigma_fn is not None:
            sigma = sigma_fn(p)
        else:
            sigma = sample_sigma(grid, p, medium, scroll, cfg.address_mode)
        return acc + jnp.where(inside, sigma, 0.0)

    acc = jax.lax.fori_loop(
        0, light.shadow_steps, body,
        jnp.zeros(pos01.shape[:-1], jnp.float32))
    return jnp.exp(-medium.density * acc * light.shadow_step_size)


def render_rays(
    grid,
    origins,
    directions,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    world_to_local=None,
    sigma_fn=None,
):
    """March rays through the volume. Returns RGBA, shape (..., 4).

    grid: (D,H,W) or (D,H,W,C) float grid in [0,1];
    origins/directions: (..., 3) world-space rays.
    sigma_fn: optional pos01 -> extinction override replacing the single
    grid sample (multi-volume scenes pass scene_sigma; grid may then be
    None). The shadow march uses the same field.
    """
    if world_to_local is not None:
        origins, directions = transform_rays(origins, directions,
                                             world_to_local)
    box_min = jnp.asarray(cfg.box_min, jnp.float32)
    box_max = jnp.asarray(cfg.box_max, jnp.float32)
    box_range = box_max - box_min

    t_near, t_far = intersect_aabb(origins, directions, box_min, box_max)
    hit = (t_near <= t_far) & (t_far > 0.0)
    # Clamp entry to the camera plane (deviation: the reference never has
    # the camera inside the box, frag.glsl:43 uses raw tNear).
    t0 = jnp.maximum(t_near, 0.0)

    step = jnp.float32(cfg.step_size)
    # actualSteps = min(maxSteps, int(dist/step))  (frag.glsl:46)
    n_steps = jnp.minimum(
        jnp.asarray(cfg.max_steps, jnp.float32),
        jnp.floor(jnp.maximum(t_far - t0, 0.0) / step),
    )
    n_steps = jnp.where(hit, n_steps, 0.0)

    # Normalized-entry position and step (frag.glsl:49-54).
    p0 = (origins + directions * t0[..., None] - box_min) / box_range
    step01 = step * directions / box_range

    emission = cfg.emission
    lt = light if light is not None else LightConfig()
    use_light = emission
    use_shadow = use_light and lt.shadow_steps > 0
    if use_light:
        lcol = jnp.asarray(lt.color, jnp.float32)

    batch_shape = origins.shape[:-1]

    def step_body(carry, i):
        pos, accum, trans, color = carry
        active = i < n_steps
        if emission:
            # Skip-work mask (no effect on result): transmittance early-out.
            active = active & (trans > cfg.early_stop_transmittance)
        if sigma_fn is not None:
            sigma = sigma_fn(pos)
        else:
            sigma = sample_sigma(grid, pos, medium, scroll, cfg.address_mode)
        sigma = jnp.where(active, sigma, 0.0)
        if emission:
            alpha = 1.0 - jnp.exp(-medium.density * sigma * step)
            if use_shadow:
                lT = _light_transmittance(grid, pos, medium, scroll, cfg, lt,
                                          sigma_fn=sigma_fn)
            else:
                lT = 1.0
            shade = lt.ambient + (1.0 - lt.ambient) * lT
            contrib = (trans * alpha * shade)[..., None] * lcol
            color = color + jnp.where(active[..., None], contrib, 0.0)
            trans = trans * jnp.where(active, 1.0 - alpha, 1.0)
        else:
            accum = accum + sigma
        return (pos + step01, accum, trans, color), None

    init = (
        p0,
        jnp.zeros(batch_shape, jnp.float32),
        jnp.ones(batch_shape, jnp.float32),
        jnp.zeros(batch_shape + (3,), jnp.float32),
    )
    # Rematerialize the step body in the backward pass: scan stores only the
    # O(steps x rays) carries, not the per-step gather intermediates — the
    # memory/FLOPs trade SURVEY.md section 7 calls out for 1080p backward.
    (pos, accum, trans, color), _ = jax.lax.scan(
        jax.checkpoint(step_body),
        init, jnp.arange(cfg.max_steps, dtype=jnp.float32))

    background = jnp.asarray(cfg.background, jnp.float32)
    if emission:
        rgb = color + trans[..., None] * background
        alpha = 1.0 - trans
    else:
        # accumDist *= stepSize; color = 1 - exp(-density*accum)
        # (frag.glsl:76-79) — monochrome.
        od = medium.density * accum * step
        gray = 1.0 - jnp.exp(-od)
        rgb = jnp.where(hit[..., None], gray[..., None],
                        jnp.broadcast_to(background, batch_shape + (3,)))
        alpha = jnp.where(hit, 1.0, 0.0)
    return jnp.concatenate([rgb, alpha[..., None]], axis=-1)


def render_rays_sliced(
    grid,
    origins,
    directions,
    plan,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    light_volume=None,
    sigma_fn=None,
):
    """Gather-based oracle for the *sliced* quadrature (ops/sweep.py).

    Marches each ray by sampling at the sweep plan's slice-plane crossings
    with per-ray segment lengths — numerically the same integral the
    slice-sweep computes, expressed per ray so it can be checked on
    CPU against closed forms and so `sweep_render` can be allclose-tested
    end to end (slow path; tests only).
    """
    box_min = jnp.asarray(cfg.box_min, jnp.float32)
    box_range = jnp.asarray(cfg.box_max, jnp.float32) - box_min
    c_k, c_a, c_b = plan.coord_order
    w = directions / box_range
    e01 = (origins - box_min) / box_range
    wk = w[..., c_k]
    u = w[..., c_b] / wk
    v = w[..., c_a] / wk
    S = plan.slice_z.shape[0]
    rng = plan.box_range  # (k, a, b) order
    seglen = (1.0 / S) * jnp.sqrt(
        rng[0] ** 2 + (v * rng[1]) ** 2 + (u * rng[2]) ** 2)

    lt = light if light is not None else LightConfig()
    lcol = jnp.asarray(lt.color, jnp.float32)
    batch_shape = origins.shape[:-1]
    emission = cfg.emission

    def step_body(carry, z_s):
        acc, trans, color, hitm = carry
        delta = z_s - e01[..., c_k]
        pa = e01[..., c_a] + delta * v
        pb = e01[..., c_b] + delta * u
        pos = jnp.zeros(batch_shape + (3,), jnp.float32)
        pos = pos.at[..., c_k].set(z_s)
        pos = pos.at[..., c_a].set(pa)
        pos = pos.at[..., c_b].set(pb)
        inbox = ((pa >= 0.0) & (pa <= 1.0) & (pb >= 0.0) & (pb <= 1.0)
                 & (delta * plan.sign > 0.0))
        maskf = inbox.astype(jnp.float32)
        if sigma_fn is not None:
            sigma = sigma_fn(pos)
        else:
            sigma = sample_sigma(grid, pos, medium, scroll, cfg.address_mode)
        sigma = sigma * maskf
        if emission:
            live = (trans > cfg.early_stop_transmittance).astype(jnp.float32)
            alpha = live * (1.0 - jnp.exp(-medium.density * sigma * seglen))
            if light_volume is not None:
                from .sampling import sample_trilinear
                lT = sample_trilinear(light_volume, pos, cfg.address_mode)
                shade = lt.ambient + (1.0 - lt.ambient) * jnp.clip(
                    lT, 0.0, 1.0)
            else:
                shade = 1.0
            wgt = trans * alpha * shade
            color = color + wgt[..., None] * lcol
            trans = trans * (1.0 - alpha)
        else:
            acc = acc + sigma * seglen
            hitm = jnp.maximum(hitm, maskf)
        return (acc, trans, color, hitm), None

    init = (jnp.zeros(batch_shape, jnp.float32),
            jnp.ones(batch_shape, jnp.float32),
            jnp.zeros(batch_shape + (3,), jnp.float32),
            jnp.zeros(batch_shape, jnp.float32))
    (acc, trans, color, hitm), _ = jax.lax.scan(
        jax.checkpoint(step_body), init, plan.slice_z)

    background = jnp.asarray(cfg.background, jnp.float32)
    if emission:
        rgb = color + trans[..., None] * background
        alpha = 1.0 - trans
    else:
        gray = 1.0 - jnp.exp(-medium.density * acc)
        hitp = jnp.clip(hitm, 0.0, 1.0)
        rgb = (gray[..., None] * hitp[..., None]
               + background * (1.0 - hitp[..., None]))
        alpha = hitp
    return jnp.concatenate([rgb, alpha[..., None]], axis=-1)
