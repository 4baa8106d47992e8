"""Trilinear 3D grid sampling — the replacement for the reference's
hardware sampler (`sampler3D` bound at shaders/frag.glsl:16, configured as
VK_FILTER_LINEAR + VK_SAMPLER_ADDRESS_MODE_MIRRORED_REPEAT at
VulkanCore.cpp:676-710). Filtering and addressing are explicit index math
+ gathers here.

Semantics replicated from the Vulkan spec's linear-filter path:
  * texel-center convention: texel i covers [i/N, (i+1)/N), its center at
    (i+0.5)/N, so sample position x = u*N - 0.5;
  * address modes applied per texel index: mirror (default, matches the
    reference), clamp-to-edge, wrap.

The reference samples an RGBA8 unorm texture (VulkanTexture.cpp:116-118);
this framework standardizes on float32/bfloat16 grids (documented deviation,
SURVEY.md section 7 "Numerics parity") — pass a uint8 grid through
`dequantize_uint8` to model the reference's quantization exactly in tests.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["apply_address_mode", "sample_trilinear", "dequantize_uint8"]


def apply_address_mode(idx, size, mode):
    """Map arbitrary integer texel indices into [0, size) per address mode.

    mirror: reflect with period 2*size (VK_..._MIRRORED_REPEAT);
    clamp:  clamp to edge; wrap: modulo."""
    if mode == "mirror":
        period = 2 * size
        m = jnp.remainder(idx, period)  # jnp.remainder is non-negative
        return jnp.where(m >= size, period - 1 - m, m)
    if mode == "clamp":
        return jnp.clip(idx, 0, size - 1)
    if mode == "wrap":
        return jnp.remainder(idx, size)
    raise ValueError(f"unknown address mode {mode!r}")


def dequantize_uint8(grid_u8):
    """uint8 unorm -> float32 in [0,1], as the Vulkan sampler does for
    VK_FORMAT_R8G8B8A8_UNORM (VulkanTexture.cpp:116)."""
    return grid_u8.astype(jnp.float32) * jnp.float32(1.0 / 255.0)


def sample_trilinear(grid, coords, address_mode="mirror"):
    """Trilinearly sample a 3D grid at normalized coordinates.

    grid:   (D, H, W) or (D, H, W, C), float; indexed [z][y][x] matching the
            reference's z-major voxel layout (TestMain.cpp:69-90).
    coords: (..., 3) with components (x, y, z) in texture space, normalized
            so [0,1] spans the grid (same convention as GLSL texture()).
    Returns (...,) or (..., C) matching grid channels.
    """
    squeeze = grid.ndim == 3
    if squeeze:
        grid = grid[..., None]
    D, H, W, C = grid.shape

    coords = jnp.asarray(coords)
    cdt = grid.dtype if jnp.issubdtype(grid.dtype, jnp.floating) else jnp.float32
    x = coords[..., 0].astype(jnp.float32) * W - 0.5
    y = coords[..., 1].astype(jnp.float32) * H - 0.5
    z = coords[..., 2].astype(jnp.float32) * D - 0.5

    x0f, y0f, z0f = jnp.floor(x), jnp.floor(y), jnp.floor(z)
    fx = (x - x0f).astype(cdt)
    fy = (y - y0f).astype(cdt)
    fz = (z - z0f).astype(cdt)
    x0, y0, z0 = x0f.astype(jnp.int32), y0f.astype(jnp.int32), z0f.astype(jnp.int32)

    x0w = apply_address_mode(x0, W, address_mode)
    x1w = apply_address_mode(x0 + 1, W, address_mode)
    y0w = apply_address_mode(y0, H, address_mode)
    y1w = apply_address_mode(y0 + 1, H, address_mode)
    z0w = apply_address_mode(z0, D, address_mode)
    z1w = apply_address_mode(z0 + 1, D, address_mode)

    def fetch(zi, yi, xi):
        return grid[zi, yi, xi]  # XLA gather, (..., C)

    c000 = fetch(z0w, y0w, x0w)
    c100 = fetch(z0w, y0w, x1w)
    c010 = fetch(z0w, y1w, x0w)
    c110 = fetch(z0w, y1w, x1w)
    c001 = fetch(z1w, y0w, x0w)
    c101 = fetch(z1w, y0w, x1w)
    c011 = fetch(z1w, y1w, x0w)
    c111 = fetch(z1w, y1w, x1w)

    fx = fx[..., None]
    fy = fy[..., None]
    fz = fz[..., None]
    c00 = c000 + fx * (c100 - c000)
    c10 = c010 + fx * (c110 - c010)
    c01 = c001 + fx * (c101 - c001)
    c11 = c011 + fx * (c111 - c011)
    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)
    out = c0 + fz * (c1 - c0)
    return out[..., 0] if squeeze else out
