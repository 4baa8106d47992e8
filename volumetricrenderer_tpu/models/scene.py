"""Scene construction: procedural density volumes and multi-volume scenes.

The "model" in this framework (like the reference's) is a scene: a density
grid + camera + medium parameters. `build_volume` replicates the reference's
CPU volume bake (TestMain.cpp:43-92) on-device:

  per channel: generate noise at voxel*frequency with a per-channel seed
  (TestMain.cpp:59-62), min-max normalize over the grid, invert (1 - n)
  (TestMain.cpp:75-78), optionally sharpen by an integer power
  (channel 0 uses pow4, TestMain.cpp:80), optionally quantize to uint8
  (TestMain.cpp:84-87).

Known reference bug not reproduced: TestMain.cpp:60 writes the second
cellular channel into noiseOutput1, clobbering channel 0's data while
channel 0's normalization range still comes from the first pass — we build
each channel from its own buffer (the evident intent).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import VolumeConfig
from ..ops import noise as noise_ops

__all__ = ["build_volume", "build_channel", "Volume", "cloud_volume",
           "smoke_volume", "two_volume_grid", "bake_scene", "config3_scene",
           "translate_w2l"]


def build_channel(kind, size, frequency, seed, octaves=1, sharpen_power=1):
    """One normalized channel in [0, 1]: noise -> min-max normalize ->
    invert -> sharpen (TestMain.cpp:64-81)."""
    raw = noise_ops.noise_grid(kind, size, frequency, seed, octaves=octaves)
    lo = jnp.min(raw)
    hi = jnp.max(raw)
    n = 1.0 - (raw - lo) / jnp.maximum(hi - lo, 1e-12)
    if sharpen_power > 1:
        n = n ** sharpen_power
    return n


def build_volume(cfg: VolumeConfig):
    """Build the full (size, size, size, C) float32 grid in [0, 1].

    With quantize_uint8=True the values are additionally snapped to the
    256-level unorm lattice the reference stores (TestMain.cpp:84-87),
    for bit-faithful parity testing."""
    channels = [
        build_channel(ch.kind, cfg.size, ch.frequency, ch.seed,
                      octaves=ch.octaves, sharpen_power=ch.sharpen_power)
        for ch in cfg.channels
    ]
    grid = jnp.stack(channels, axis=-1)
    if cfg.quantize_uint8:
        grid = jnp.floor(grid * 255.0) / 255.0
    return grid


@dataclasses.dataclass(frozen=True)
class Volume:
    """A density grid with an optional world transform. The reference's
    single cube is Volume(grid, world_to_local=inverse(Model))
    (TestMain.cpp:230, frag.glsl:36-37)."""

    grid: jnp.ndarray  # (D, H, W) or (D, H, W, C)
    world_to_local: Optional[jnp.ndarray] = None  # (4, 4) or None (identity)


def cloud_volume(size, seed=7, octaves=5, coverage=0.45):
    """A puffy FBM cloud: fbm noise thresholded softly by a radial falloff —
    the BASELINE "FBM cloud volume" (configs 2-5)."""
    n = build_channel("fbm", size, 4.0 / size, seed, octaves=octaves)
    idx = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size - 0.5
    zz, yy, xx = jnp.meshgrid(idx, idx, idx, indexing="ij")
    r = jnp.sqrt(xx * xx + yy * yy + zz * zz) * 2.0
    falloff = jnp.clip(1.0 - r, 0.0, 1.0)
    d = jnp.clip(n - (1.0 - coverage), 0.0, 1.0) * falloff
    return d / jnp.maximum(jnp.max(d), 1e-6)


def smoke_volume(size, seed=23, octaves=4):
    """A wispy smoke column: FBM modulated by a vertical gradient and a
    horizontal Gaussian core (the second volume of BASELINE config 3)."""
    n = build_channel("fbm", size, 6.0 / size, seed, octaves=octaves)
    idx = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    zz, yy, xx = jnp.meshgrid(idx, idx, idx, indexing="ij")
    core = jnp.exp(-(((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / 0.02))
    d = n * core * zz
    return d / jnp.maximum(jnp.max(d), 1e-6)


def translate_w2l(tx, ty, tz):
    """world_to_local for a volume whose model transform translates it by
    (tx, ty, tz): local = world - t (the inverse, matching the reference's
    WorldToLocal = inverse(Model), TestMain.cpp:230)."""
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(jnp.asarray([-tx, -ty, -tz], jnp.float32))


def bake_scene(volumes, size, cfg):
    """Resample a multi-volume scene onto one shared (size^3) grid over the
    config box — the fast path for multi-volume rendering: one
    trilinear bake per scene change, then every frame runs the full-speed
    single-grid slice sweep (ops/sweep.py). Densities of overlapping volumes
    add; positions outside a volume's own box contribute zero (matching
    ops/integrate.scene_sigma). Exact when transforms are voxel-aligned
    translations at equal resolution; otherwise one extra trilinear filter
    vs the per-ray oracle (standard proxy-grid approximation)."""
    from ..ops.sampling import sample_trilinear

    box_min = jnp.asarray(cfg.box_min, jnp.float32)
    box_range = jnp.asarray(cfg.box_max, jnp.float32) - box_min
    idx = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    zz, yy, xx = jnp.meshgrid(idx, idx, idx, indexing="ij")
    pos01 = jnp.stack([xx, yy, zz], axis=-1)  # (D, H, W, 3), (x, y, z)
    world = pos01 * box_range + box_min
    total = jnp.zeros((size, size, size), jnp.float32)
    for vol in volumes:
        if vol.world_to_local is None:
            p = pos01
        else:
            m = jnp.asarray(vol.world_to_local, jnp.float32)
            local = world @ m[:3, :3].T + m[:3, 3]
            p = (local - box_min) / box_range
        g = vol.grid[..., 0] if vol.grid.ndim == 4 else vol.grid
        inside = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
        total = total + jnp.where(inside,
                                  sample_trilinear(g, p, cfg.address_mode),
                                  0.0)
    return total


def config3_scene(size, cloud_seed=7, smoke_seed=23):
    """BASELINE config 3 as specified: a cloud + smoke TWO-VOLUME scene —
    two independent grids with per-volume world transforms (cloud raised,
    smoke column below it), not a pre-baked single grid."""
    half = 2.0 / size  # one voxel pitch of the [-1,1] box
    cloud = Volume(cloud_volume(size, seed=cloud_seed),
                   translate_w2l(0.0, 0.0, round(0.5 / half) * half))
    smoke = Volume(smoke_volume(size, seed=smoke_seed),
                   translate_w2l(0.0, 0.0, -round(0.3 / half) * half))
    return [cloud, smoke]


def two_volume_grid(size, cloud_seed=7, smoke_seed=23):
    """BASELINE config 3's "cloud + smoke two-volume scene" baked into one
    grid (cloud shifted up, smoke rising below it); densities add where
    they overlap."""
    half = size
    cloud = cloud_volume(half, seed=cloud_seed)
    smoke = smoke_volume(half, seed=smoke_seed)
    return jnp.clip(cloud + smoke * 0.7, 0.0, 1.0)
