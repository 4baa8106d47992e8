"""Separable resampling as banded weight matrices — a matmul
reformulation of texture gathers.

The reference's hardware sampler (`sampler3D`, shaders/frag.glsl:16,
configured VK_FILTER_LINEAR + MIRRORED_REPEAT at VulkanCore.cpp:676-710)
is not translated gather for gather; it is *reformulated*.

The reformulation: 1D linear resampling at affine sample positions is a
2-banded matrix multiply.  `W[i, c] = (1-f_i)[c == wrap(i0_i)] +
f_i[c == wrap(i0_i + 1)]`, so `out = W @ line` — dense matrix work.
Separable bilinear resampling of a
slice is then two matmuls, `Wa @ slice @ Wb.T`, and the slice-sweep
renderer (ops/sweep.py) builds the whole volume integral out of them.

Address modes (mirror/clamp/wrap) fold into the index math of the matrix
build, reproducing the Vulkan sampler semantics of ops/sampling.py.
"""
from __future__ import annotations

import jax.numpy as jnp

from .sampling import apply_address_mode

__all__ = ["linear_resample_matrix", "sample_bilinear_2d"]


def linear_resample_matrix(u01, n_in, address_mode="mirror",
                           dtype=jnp.float32, zero_outside=False):
    """Weight matrix for 1D linear resampling at normalized positions.

    u01:  (n_out,) sample positions, [0,1] spanning the n_in texels
          (GLSL texture() convention: texel i centered at (i+0.5)/n_in,
          matching ops/sampling.py).
    Returns W (n_out, n_in) with at most two non-zeros per row such that
    `W @ line` equals linear interpolation of `line` at u01 under the
    given address mode. Differentiable w.r.t. the resampled data (it is
    a constant matrix w.r.t. the grid); u01 may be traced (animated
    cameras rebuild W on device — it is cheap iota math).

    zero_outside=True zeroes rows whose position leaves [0,1] (used by the
    light sweep, where out-of-box means "no medium" rather than a sampler
    address mode).
    """
    n_out = u01.shape[0]
    p = u01.astype(jnp.float32) * n_in - 0.5
    i0 = jnp.floor(p)
    f = (p - i0).astype(dtype)
    i0 = i0.astype(jnp.int32)
    if address_mode == "zero":
        # Vacuum outside the texel support: out-of-range taps contribute
        # nothing (the physically-correct boundary for the light sweep;
        # not a Vulkan sampler mode).
        a0 = jnp.clip(i0, 0, n_in - 1)
        a1 = jnp.clip(i0 + 1, 0, n_in - 1)
        in0 = ((i0 >= 0) & (i0 < n_in)).astype(dtype)
        in1 = ((i0 + 1 >= 0) & (i0 + 1 < n_in)).astype(dtype)
    else:
        a0 = apply_address_mode(i0, n_in, address_mode)
        a1 = apply_address_mode(i0 + 1, n_in, address_mode)
        in0 = in1 = jnp.ones((), dtype)
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    w0 = jnp.where(cols == a0[:, None], ((1.0 - f) * in0)[:, None], 0.0)
    w1 = jnp.where(cols == a1[:, None], (f * in1)[:, None], 0.0)
    W = (w0 + w1).astype(dtype)
    if zero_outside:
        inr = ((u01 >= 0.0) & (u01 <= 1.0)).astype(dtype)
        W = W * inr[:, None]
    return W


def sample_bilinear_2d(img, rows01, cols01, address_mode="clamp"):
    """Bilinear sample of a 2D image at normalized positions (gather-based;
    used only for the once-per-frame base-image -> screen warp, never in
    the per-slice hot path).

    img: (H, W) or (H, W, C); rows01/cols01: (...,) normalized coords with
    the same texel-center convention as sample_trilinear.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    py = rows01.astype(jnp.float32) * H - 0.5
    px = cols01.astype(jnp.float32) * W - 0.5
    y0f, x0f = jnp.floor(py), jnp.floor(px)
    fy = (py - y0f)[..., None]
    fx = (px - x0f)[..., None]
    y0 = y0f.astype(jnp.int32)
    x0 = x0f.astype(jnp.int32)
    y0w = apply_address_mode(y0, H, address_mode)
    y1w = apply_address_mode(y0 + 1, H, address_mode)
    x0w = apply_address_mode(x0, W, address_mode)
    x1w = apply_address_mode(x0 + 1, W, address_mode)
    c00 = img[y0w, x0w]
    c01 = img[y0w, x1w]
    c10 = img[y1w, x0w]
    c11 = img[y1w, x1w]
    c0 = c00 + fx * (c01 - c00)
    c1 = c10 + fx * (c11 - c10)
    out = c0 + fy * (c1 - c0)
    return out[..., 0] if squeeze else out
