"""Medium evaluation helpers: materializing the reference's 4-channel
combine as a dense extinction volume.

The reference evaluates sigma per SAMPLE: 4 trilinear fetches at
per-channel scaled + scrolled coordinates combined as
(s1*s2)*(s3+s4)*scale (shaders/frag.glsl:63-71). Paths that need a plain
per-voxel sigma field — the light-propagation sweep (ops/lighting.py) and
baked multi-volume scenes (render.render_scene) — get it by evaluating
that expression once at every voxel center: three banded-matrix resamples
per channel (dense matmuls, ops/resample.py), then the combine.

Exact at voxel centers; consumers then interpolate the *combined* field
(interpolate-after-combine) where the reference interpolates each channel
then combines. The two agree at voxel centers and differ by O(h^2) between
them — the standard proxy-field approximation, documented per call site.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import MediumConfig
from .resample import linear_resample_matrix

__all__ = ["materialize_sigma"]


def materialize_sigma(grid4, medium: MediumConfig, scroll=None,
                      address_mode="mirror", dtype=jnp.float32):
    """(D, H, W, 4) channel grid -> (D, H, W) combined extinction sigma
    at voxel centers, including medium.sample_scale.

    scroll: optional (4, 3) per-channel scroll offsets in (x, y, z) coord
    order (ops/integrate.reference_media_scroll); traced values rebuild
    the banded matrices on device (cheap iota math). Differentiable in
    grid4 (three matmuls per channel — the adjoint is their transposes)."""
    if grid4.ndim != 4 or grid4.shape[-1] < 4:
        raise ValueError("reference combine needs a (D, H, W, 4) grid")
    chans = []
    for c in range(4):
        sc = medium.channel_coord_scale[c]
        if scroll is not None:
            off = scroll[c] * medium.channel_scroll_weight[c]  # (3,) xyz
        else:
            off = jnp.zeros(3, jnp.float32)
        g = grid4[..., c]
        # Grid dims are (z, y, x) = dims (0, 1, 2); coord axis of grid
        # dim d is (2 - d) in the (x, y, z) offset vector.
        for dim in range(3):
            n = g.shape[dim]
            q01 = ((jnp.arange(n, dtype=jnp.float32) + 0.5) / n * sc
                   + off[2 - dim])
            Wm = linear_resample_matrix(q01, n, address_mode, dtype)
            g = jnp.moveaxis(
                jnp.tensordot(Wm, g.astype(dtype), axes=(1, dim)), 0, dim)
        chans.append(g)
    s1, s2, s3, s4 = chans
    return ((s1 * s2) * (s3 + s4) * medium.sample_scale).astype(jnp.float32)
