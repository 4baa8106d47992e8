"""Light-transmittance volume via a directional sweep — the
replacement for the per-sample nested shadow march (BASELINE config 4).

The reference has no lighting at all (frag.glsl is absorption-only); the
fixed-quadrature extension marches a secondary ray toward the light from
*every primary sample* (ops/integrate._light_transmittance) — an
O(rays x steps x shadow_steps) gather storm. This module computes the
standard light-propagation factorization instead (half-angle slicing
family): sweep the volume's slices from the light side inward, carrying
accumulated optical depth and re-aligning it each step with the light's
constant shear — two *constant* resample matrices per step, i.e. O(volume)
matmul work total, independent of ray count:

    tau_s = Shift(tau_{s-1} + sigma_{s-1} * dl),     tau_0 = 0
    L_s   = exp(-density * tau_s)

`Shift` resamples by the light's inter-slice offset with zero weight
outside the box (no medium there). L is a per-voxel transmittance grid;
both render paths (the slice sweep and the per-ray oracle) then *sample* the
same L, so shading stays exactly comparable (render_rays_sliced /
sweep_render take it as `light_volume`).

Gradients flow through the scan by autodiff (transposed matmuls again).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LightConfig, MediumConfig, RenderConfig
from .resample import linear_resample_matrix
from .sweep import _axes_for

__all__ = ["light_transmittance_volume"]


@jax.named_scope("light_sweep")
def light_transmittance_volume(
    grid,
    light: LightConfig,
    cfg: RenderConfig,
    medium: MediumConfig,
    scroll=None,
):
    """Per-voxel transmittance toward a directional light, (D, H, W) in
    [0, 1]. combine="single" uses channel 0 directly; the 4-channel
    reference combine (frag.glsl:63-71) first materializes the combined
    sigma field at voxel centers (ops/media.materialize_sigma — exact at
    centers, interpolate-after-combine between them)."""
    if medium.combine == "reference":
        from .media import materialize_sigma
        sigma = materialize_sigma(grid, medium, scroll, cfg.address_mode)
    elif medium.combine == "single":
        g = grid[..., 0] if grid.ndim == 4 else grid
        sigma = g * medium.sample_scale
    else:
        raise ValueError(f"unknown combine mode {medium.combine!r}")

    # Light direction in normalized coords; dominant axis of the sweep.
    ldir = np.asarray(light.direction, np.float64)
    ldir = ldir / np.linalg.norm(ldir)
    box_min = np.asarray(cfg.box_min, np.float64)
    box_range = np.asarray(cfg.box_max, np.float64) - box_min
    w = ldir / box_range
    axis = int(np.argmax(np.abs(w)))
    sign = 1 if w[axis] > 0 else -1
    perm, coord_order = _axes_for(axis)
    c_k, c_a, c_b = coord_order

    gperm = jnp.transpose(sigma, perm)  # (S, A, B)
    S, A, B = gperm.shape

    # Inter-slice sample offset toward the light (normalized coords) and
    # the world-space path length of one slice step.
    dz = 1.0 / S
    shift_a = dz * w[c_a] / abs(w[axis])
    shift_b = dz * w[c_b] / abs(w[axis])
    rng = box_range[[c_k, c_a, c_b]]
    dl = dz * float(np.sqrt(
        rng[0] ** 2 + (shift_a / dz * rng[1]) ** 2
        + (shift_b / dz * rng[2]) ** 2))

    # Constant shear matrices: resample the carried optical depth from the
    # previous (light-side) slice at positions offset toward the light.
    # shift_* already carries the toward-light sign (dz * w / |w_k|).
    a01 = (jnp.arange(A, dtype=jnp.float32) + 0.5) / A + jnp.float32(shift_a)
    b01 = (jnp.arange(B, dtype=jnp.float32) + 0.5) / B + jnp.float32(shift_b)
    Wa = jax.lax.stop_gradient(linear_resample_matrix(
        a01, A, "zero", zero_outside=True))
    Wb = jax.lax.stop_gradient(linear_resample_matrix(
        b01, B, "zero", zero_outside=True))

    # Sweep from the light side inward. sign > 0 means the light lies
    # toward +k, so the highest-k slice is lit first.
    slices = gperm[::-1] if sign > 0 else gperm

    def step(tau_prev, sigma_prev):
        tau = Wa @ (tau_prev + sigma_prev * dl) @ Wb.T
        return tau, tau

    tau0 = jnp.zeros((A, B), jnp.float32)
    # tau_s excludes the slice's own density (matches the fixed-quadrature
    # shadow march, which starts sampling at step 1 — integrate.py).
    _, taus = jax.lax.scan(step, tau0, slices[:-1])
    taus = jnp.concatenate([tau0[None], taus], axis=0)
    if sign > 0:
        taus = taus[::-1]
    L = jnp.exp(-medium.density * taus)
    return jnp.transpose(L, tuple(np.argsort(perm)))
