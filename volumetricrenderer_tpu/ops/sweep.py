"""Slice-sweep volume renderer — the hot path.

The reference's hot loop is a per-pixel serial ray march with 4 trilinear
texture fetches per step (shaders/frag.glsl:57-75) — a *gather-bound*
formulation. This module *reformulates* the integral instead of
translating the shader: a shear-warp factorization (after Lacroute &
Levoy '94) whose per-slice resample is dense matrix multiplication.

Key identity: for a pinhole camera, the sample position of a ray on volume
slice plane k = z_s is **affine** in the ray's slope coordinates
(u, v) = (w_b/w_k, w_a/w_k):

    a01 = e_a + (z_s - e_k) * v ,   b01 = e_b + (z_s - e_k) * u .

So rendering onto a regular (v, u) "base grid" makes every slice's 2D
resampling *separable and affine* — two banded matrix multiplies
(ops/resample.py):

    R_s = Wa(z_s) @ G_s @ Wb(z_s)^T .

The volume integral becomes a `lax.scan` over slices of (2 matmuls +
elementwise Beer-Lambert compositing), with a final once-per-frame
projective warp from the base grid to actual screen pixels. Gradients come
from autodiff: the backward pass is *transposed matmuls* — no scatter, no
gather, no atomics (the contention-free voxel-gradient accumulation
SURVEY.md §7 "Hard parts" asks for falls out of the formulation).

Quadrature note: the sweep samples at slice-plane crossings with per-ray
segment lengths, not at fixed per-ray steps like frag.glsl:42-46. That is a
*different, standard* quadrature of the same integral; RenderConfig.quadrature
selects "fixed" (reference parity, ops/integrate.render_rays) or "sliced"
(this module; its matching jnp oracle is ops/integrate.render_rays_sliced).
Both converge to the same integral as steps -> inf.

Scaling (SURVEY.md §5.7-5.9): slices along the sweep axis are this
framework's sequence dimension. The compositing carry (color, transmittance)
is an **associative monoid** (C = C1 + T1*C2, T = T1*T2), so a z-sharded
volume (config 5) renders each slab independently and combines slab images
in closed form — see parallel/.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LightConfig, MediumConfig, RenderConfig
from .camera import Camera, camera_rays
from .resample import linear_resample_matrix
from .sampling import apply_address_mode

__all__ = ["SweepPlan", "plan_sweep", "plan_base_dims", "plan_signature",
           "with_warp_band", "sweep_render", "base_rays",
           "warp_base_to_pixels", "composite_base_maps", "finish_image"]


# Grid dims are (z, y, x) = dims (0, 1, 2); coord axes are (x, y, z).
# coord c <-> grid dim (2 - c).
def _axes_for(coord_axis: int) -> Tuple[Tuple[int, int, int],
                                        Tuple[int, int, int]]:
    """Returns (perm, coord_order): perm transposes the grid so the sweep
    axis is dim 0 (remaining grid dims keep their relative order, becoming
    the slice's rows=a and cols=b); coord_order = (c_k, c_a, c_b)."""
    gd_k = 2 - coord_axis
    rest = [d for d in range(3) if d != gd_k]
    perm = (gd_k, rest[0], rest[1])
    coord_order = (coord_axis, 2 - rest[0], 2 - rest[1])
    return perm, coord_order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _camera_rays_np(cam: Camera):
    """Host-side numpy twin of ops/camera.camera_rays (plans are built on
    host, so the axis choice needs no device round trip)."""
    w, h = cam.width, cam.height
    eye = np.asarray(cam.eye, np.float64)
    right = np.asarray(cam.right, np.float64)
    up = np.asarray(cam.up, np.float64)
    forward = np.asarray(cam.forward, np.float64)
    tan_half = float(np.asarray(cam.tan_half_fov))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
    ys = 1.0 - (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0
    px, py = np.meshgrid(xs, ys, indexing="xy")
    dirs = (px[..., None] * (right * tan_half * cam.aspect)
            + py[..., None] * (up * tan_half) + forward)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(eye, dirs.shape)
    return origins, dirs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Static geometry of one sweep: dominant axis, base grid, slice set,
    and the screen-warp coordinates. Array fields may be traced (animated
    cameras); meta fields are static under jit."""

    # --- data (traced) ---
    eye01: jnp.ndarray       # (3,) eye in normalized coords, (k, a, b) order
    v_grid: jnp.ndarray      # (Hb,) slope along a per base row
    u_grid: jnp.ndarray      # (Wb,) slope along b per base col
    slice_z: jnp.ndarray     # (S,) normalized sweep-axis slice positions,
                             #      ordered front-to-back
    seglen: jnp.ndarray      # (Hb, Wb) world path length per slice step
    warp_rows01: jnp.ndarray  # (H, W) pixel -> base-grid row coords
    warp_cols01: jnp.ndarray  # (H, W) pixel -> base-grid col coords
    warp_tile_lo: jnp.ndarray  # (n_base_tiles, 3) [pixel-rect row, col,
                               #  active] per base tile (warp windows)
    warp_ptile_lo: jnp.ndarray  # (n_pixel_tiles, 3) [base-window row, col,
                                #  active] per pixel tile (the transposed
                                #  rect table: pixel-major forward warp)
    box_range: jnp.ndarray   # (3,) world box extent, (k, a, b) order
    box_min: jnp.ndarray     # (3,) world box min, (k, a, b) order

    # --- meta (static) ---
    axis: int = dataclasses.field(metadata=dict(static=True))  # coord axis
    sign: int = dataclasses.field(metadata=dict(static=True))  # ray dir along axis
    perm: Tuple[int, int, int] = dataclasses.field(metadata=dict(static=True))
    coord_order: Tuple[int, int, int] = dataclasses.field(
        metadata=dict(static=True))
    identity_warp: bool = dataclasses.field(metadata=dict(static=True))
    warp_band: Tuple[int, int] = dataclasses.field(
        metadata=dict(static=True))  # pixel-rect (rows, cols) per base tile
    warp_blk: int = dataclasses.field(metadata=dict(static=True))  # base tile
    pix_band: Tuple[int, int] = dataclasses.field(
        default=(0, 0), metadata=dict(static=True))  # base-texel window
    # (rows, cols) per PIXEL tile — the transposed warp band. (0, 0)
    # disables the pixel-major forward warp (base-major RMW fallback).
    pix_blk: Tuple[int, int] = dataclasses.field(
        default=(64, 128), metadata=dict(static=True))  # pixel tile dims

    @property
    def base_shape(self):
        return (self.v_grid.shape[0], self.u_grid.shape[0])


def _host_geometry(
    camera: Camera,
    grid_shape: Tuple[int, ...],
    cfg: RenderConfig,
    world_to_local=None,
    supersample: float = 1.5,
    n_slices: Optional[int] = None,
    max_base_dim: int = 3072,
    min_axis_component: float = 0.05,
    force_base_dims: Optional[Tuple[int, int]] = None,
):
    """Host-side (numpy) sweep geometry shared by plan_sweep and
    plan_base_dims: axis choice, base-grid axes, slice set."""
    o, d = _camera_rays_np(camera)
    if world_to_local is not None:
        m = np.asarray(world_to_local, np.float64)
        o = o @ m[:3, :3].T + m[:3, 3]
        d = d @ m[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    box_min = np.asarray(cfg.box_min, np.float64)
    box_range = np.asarray(cfg.box_max, np.float64) - box_min
    e01_xyz = (np.asarray(o.reshape(-1, 3)[0]) - box_min) / box_range
    w = d / box_range  # direction in normalized coords (unnormalized length)

    # Dominant axis: maximize the minimum |w_c| over all pixels.
    min_abs = np.abs(w).reshape(-1, 3).min(axis=0)
    axis = int(np.argmax(min_abs))
    if min_abs[axis] < min_axis_component:
        raise ValueError(
            f"sweep unsupported: min |w_axis| = {min_abs[axis]:.4f} < "
            f"{min_axis_component} (rays near-parallel to every axis plane)")
    wk = w[..., axis]
    sgn = np.sign(wk.reshape(-1)[0])
    if not np.all(np.sign(wk) == sgn):
        raise ValueError("sweep unsupported: mixed ray direction signs "
                         "along the dominant axis")
    sign = int(sgn)

    perm, coord_order = _axes_for(axis)
    c_k, c_a, c_b = coord_order
    u = w[..., c_b] / wk  # (H, W)
    v = w[..., c_a] / wk

    # Slices at voxel layer centers of the (transposed) grid by default.
    depth = grid_shape[perm[0]]
    S = int(n_slices) if n_slices is not None else int(depth)
    z01 = (np.arange(S) + 0.5) / S
    slice_z = z01 if sign > 0 else z01[::-1]  # front-to-back

    # Signed slice-delta range in front of the eye (for the box slope
    # footprint below).
    deltas = z01 - e01_xyz[c_k]
    front = deltas * sign > 0
    delta_near = deltas[front][np.argmin(np.abs(deltas[front]))] \
        if front.any() else None

    # Base grid per transverse axis. Two key choices (both exact — the
    # resample matrices accept arbitrary monotone row positions):
    #  * extent: the pixel slope range CLIPPED to the box's slope
    #    footprint (slopes that never enter [0,1] over any front slice
    #    cannot contribute; they become explicit warp-time misses). For
    #    oblique cameras this shrinks the base image several-fold.
    #  * spacing: uniform in atan(slope). Pixels of a pinhole camera are
    #    ~uniform in angle, so slope-uniform spacing would waste most of
    #    its resolution near the steep end of an oblique view.
    def base_axis(q, e_t, n_force=None):
        th = np.arctan(q)
        # box footprint in slope space (guard: eye near the first slice
        # plane -> unbounded slopes -> no clipping)
        lo, hi = float(q.min()), float(q.max())
        if delta_near is not None and abs(delta_near) > 0.02:
            cand = [(b - e_t) / dd for b in (0.0, 1.0)
                    for dd in (delta_near, float(deltas[front].max()
                                                 if sign > 0 else
                                                 deltas[front].min()))]
            lo = max(lo, min(cand))
            hi = min(hi, max(cand))
            if not lo < hi:  # camera never sees the box on this axis
                lo, hi = float(q.min()), float(q.max())
        th_lo, th_hi = math.atan(lo), math.atan(hi)
        # Pixel angular spacing: per-direction medians, keep the LARGER —
        # the base grid must resolve the direction along which this slope
        # actually varies. (Pooling both directions' diffs and taking one
        # median collapses for near-axis cameras, where the cross
        # direction's diffs are ~0 and drag the median down, exploding the
        # base dim ~10x for no resolution gain.)
        meds = []
        for ax in (0, 1):
            if th.shape[ax] > 1:
                d1 = np.abs(np.diff(th, axis=ax)).reshape(-1)
                d1 = d1[d1 > 1e-12]
                if d1.size:
                    meds.append(float(np.median(d1)))
        spacing = max(meds) if meds else 0.0
        if not spacing or not np.isfinite(spacing):
            spacing = max(th_hi - th_lo, 1e-6) / 64
        if n_force is not None:
            # Compile-stable animation: a caller-fixed dim (usually the max
            # over an animation's frames) — exact regardless of value, the
            # resample matrices accept arbitrary row positions.
            n = int(n_force)
        else:
            n = int(math.ceil((th_hi - th_lo) / spacing * supersample)) + 2
            n = max(128, min(_round_up(n, 128), max_base_dim))
        pad = (th_hi - th_lo) / n
        th_lo, th_hi = th_lo - pad, th_hi + pad
        centers = th_lo + (np.arange(n) + 0.5) / n * (th_hi - th_lo)
        return np.tan(centers), th_lo, th_hi, n

    fh, fw = force_base_dims if force_base_dims is not None else (None, None)
    u_grid, thu_lo, thu_hi, Wb = base_axis(u, e01_xyz[c_b], fw)
    v_grid, thv_lo, thv_hi, Hb = base_axis(v, e01_xyz[c_a], fh)

    rng_perm = box_range[[c_k, c_a, c_b]]
    return dict(axis=axis, sign=sign, perm=perm, coord_order=coord_order,
                e01_xyz=e01_xyz, u_grid=u_grid, v_grid=v_grid,
                thu_lo=thu_lo, thu_hi=thu_hi, thv_lo=thv_lo, thv_hi=thv_hi,
                Hb=Hb, Wb=Wb, slice_z=slice_z, S=S, box_min=box_min,
                box_range=box_range, rng_perm=rng_perm,
                world_to_local=world_to_local)


def plan_base_dims(camera: Camera, grid_shape, cfg: RenderConfig,
                   world_to_local=None, supersample: float = 1.5,
                   max_base_dim: int = 3072):
    """Cheap host-only probe of the base-grid dims a camera would get:
    returns (Hb, Wb, axis, sign). Animation drivers probe every frame,
    take the max dims, and pass them back via plan_sweep's
    force_base_dims so all frames share one jit executable
    (the interactive-loop parity item: TestMain.cpp:173-256 runs 60 fps
    with live camera updates; re-jitting per frame would be the analogue
    of rebuilding the Vulkan pipeline per frame)."""
    g = _host_geometry(camera, grid_shape, cfg, world_to_local, supersample,
                       None, max_base_dim)
    return g["Hb"], g["Wb"], g["axis"], g["sign"]


def plan_signature(plan: SweepPlan):
    """Everything that selects a distinct jit executable for a fixed
    image/volume size: static meta + array shapes. Two frames with equal
    signatures reuse one compiled render."""
    return (plan.axis, plan.sign, plan.perm, plan.base_shape,
            plan.slice_z.shape[0], plan.warp_band, plan.warp_blk,
            plan.identity_warp, plan.pix_band, plan.pix_blk)


def with_warp_band(plan: SweepPlan, band) -> SweepPlan:
    """Replace the warp band with a caller-unified (>=) one, re-clamping
    the per-tile pixel-rect origins so the larger window stays in-image.
    Exact for any band >= the plan's own: the rect is a cover of the
    pixels whose bilinear splat touches the tile — pixels gathered by a
    larger cover splat zero weight to this tile.

    band may be a 4-tuple (rect rows, rect cols, base-window rows,
    base-window cols): the last two unify the pixel-major forward warp's
    transposed band (same cover argument, over base texels). A 2-tuple
    leaves pix_band unchanged."""
    H, W = plan.warp_rows01.shape
    Hb, Wb = plan.base_shape
    band_r, band_c = int(band[0]), int(band[1])
    pix = (plan.pix_band if len(band) < 4
           else (int(band[2]), int(band[3])))
    if plan.pix_band == (0, 0):
        pix = (0, 0)  # disabled at plan time: the table was never clamped
    if (band_r, band_c) == plan.warp_band and pix == plan.pix_band:
        return plan
    assert band_r >= plan.warp_band[0] and band_c >= plan.warp_band[1]
    tile_lo = jnp.minimum(
        plan.warp_tile_lo,
        jnp.asarray([max(H - band_r, 0), max(W - band_c, 0), 1], jnp.int32))
    ptile_lo = plan.warp_ptile_lo
    if pix != plan.pix_band and pix != (0, 0):
        # (0, 0) DISABLES the pixel-major forward (table goes unused);
        # any other replacement must be a >= cover, re-clamped in-bounds.
        assert pix[0] >= plan.pix_band[0] and pix[1] >= plan.pix_band[1]
        ptile_lo = jnp.maximum(
            jnp.minimum(plan.warp_ptile_lo,
                        jnp.asarray([max(Hb - pix[0], 0),
                                     max(Wb - pix[1], 0), 1], jnp.int32)),
            0)
    return dataclasses.replace(plan, warp_band=(band_r, band_c),
                               warp_tile_lo=jnp.maximum(tile_lo, 0),
                               pix_band=pix, warp_ptile_lo=ptile_lo)


def plan_sweep(
    camera: Camera,
    grid_shape: Tuple[int, ...],
    cfg: RenderConfig,
    world_to_local=None,
    supersample: float = 1.5,
    n_slices: Optional[int] = None,
    max_base_dim: int = 3072,
    min_axis_component: float = 0.05,
    force_base_dims: Optional[Tuple[int, int]] = None,
    min_warp_band: Optional[Tuple[int, int]] = None,
    trust_band: bool = False,
) -> SweepPlan:
    """Build the static sweep geometry for a concrete camera (host-side).

    Chooses the sweep axis as the coordinate axis along which *every* pixel
    ray has the largest guaranteed direction component; rays near-parallel
    to every axis plane (|w_k| < min_axis_component, only possible with
    very wide FOV) are unsupported — callers fall back to the gather
    integrator. world_to_local mirrors frag.glsl:36-37's ray transform
    (the rotating-cube interaction, TestMain.cpp:177-190).

    force_base_dims/min_warp_band pin the shape-determining quantities for
    compile-stable animation (see plan_base_dims).

    trust_band=True (requires min_warp_band) takes min_warp_band as THE
    band without reading the device-computed one back — the only
    synchronous device round trip in a plan build. The caller must
    guarantee the band covers every reachable camera (the serve loop
    probes + pads its orbit family); an undersized band would clip warp
    rects. The per-8px-block span check is skipped too."""
    g = _host_geometry(camera, grid_shape, cfg, world_to_local, supersample,
                       n_slices, max_base_dim, min_axis_component,
                       force_base_dims)
    (axis, sign, perm, coord_order, e01_xyz, u_grid, v_grid, slice_z,
     box_min, box_range, rng_perm) = (
        g["axis"], g["sign"], g["perm"], g["coord_order"], g["e01_xyz"],
        g["u_grid"], g["v_grid"], g["slice_z"], g["box_min"],
        g["box_range"], g["rng_perm"])
    thu_lo, thu_hi, thv_lo, thv_hi = (g["thu_lo"], g["thu_hi"],
                                      g["thv_lo"], g["thv_hi"])
    Hb, Wb, S = g["Hb"], g["Wb"], g["S"]
    c_k, c_a, c_b = coord_order

    warp_tile = _pick_warp_tile(Hb, Wb)
    # Everything device-side happens in ONE jitted call on ONE packed
    # upload (host-built HxW arrays would be megabytes of host->device
    # transfer per plan, and the live serve loop builds a plan per frame).
    w2l = (np.eye(4) if world_to_local is None
           else np.asarray(world_to_local)).astype(np.float32)
    if trust_band:
        if min_warp_band is None:
            raise ValueError("trust_band requires min_warp_band")
        band_r = min(int(min_warp_band[0]), camera.height)
        band_c = min(int(min_warp_band[1]), camera.width)
        if len(min_warp_band) >= 4:
            # 4-tuple band: (pixel-rect rows, cols, base-window rows,
            # cols) — the last two trust the pixel-major fwd warp's
            # transposed band too. A legacy 2-tuple disables it
            # (pix_band stays (0, 0) -> base-major fwd).
            pwr = min(int(min_warp_band[2]), Hb)
            pwc = min(int(min_warp_band[3]), Wb)
            clamp_band = (band_r, band_c, pwr, pwc)
        else:
            pwr = pwc = 0
            clamp_band = (band_r, band_c)
    else:
        clamp_band = None
    packed = np.concatenate([
        np.asarray(camera.right, np.float32).ravel(),
        np.asarray(camera.up, np.float32).ravel(),
        np.asarray(camera.forward, np.float32).ravel(),
        np.asarray([camera.tan_half_fov], np.float32).ravel(),
        w2l.ravel(),
        np.asarray(box_range, np.float32),
        np.asarray([thu_lo, thu_hi, thv_lo, thv_hi], np.float32),
        np.asarray(rng_perm, np.float32),
        np.asarray(e01_xyz[[c_k, c_a, c_b]], np.float32),
        np.asarray(box_min[[c_k, c_a, c_b]], np.float32),
        np.asarray(v_grid, np.float32),
        np.asarray(u_grid, np.float32),
        np.ascontiguousarray(slice_z).astype(np.float32),
    ])
    ptile = _pick_pixel_tile()
    (eye01_d, box_min_d, rng_perm_d, v_grid_d, u_grid_d, slice_z_d,
     seglen, warp_rows01, warp_cols01, tile_lo, ptile_lo,
     band) = _device_plan(
        jnp.asarray(packed),
        width=camera.width, height=camera.height,
        aspect=float(camera.aspect), c_k=c_k, c_a=c_a, c_b=c_b,
        n_slices=S, tile=warp_tile, hb=Hb, wb=Wb,
        clamp_band=clamp_band,
        pb=int(_os.environ.get("VOLT_WARP_PB", 2)),
        ptile=ptile,
    )
    if not trust_band:
        band_np = np.asarray(band)  # the one synchronous round trip
        band_r, band_c = int(band_np[0]), int(band_np[1])
        pwr, pwc = int(band_np[4]), int(band_np[5])
        if min_warp_band is not None:
            band_r = min(max(band_r, int(min_warp_band[0])),
                         camera.height)
            band_c = min(max(band_c, int(min_warp_band[1])), camera.width)
            if len(min_warp_band) >= 4:
                pwr = min(max(pwr, int(min_warp_band[2])), Hb)
                pwc = min(max(pwc, int(min_warp_band[3])), Wb)
        if int(band_np[2]) > 3 or int(band_np[3]) > 3:
            raise ValueError(
                "sweep unsupported: an 8px pixel block spans >3 base "
                "tiles (extreme base/pixel density ratio); lower "
                "supersample")
        tile_lo = _clamp_tile_lo(tile_lo, max(camera.height - band_r, 0),
                                 max(camera.width - band_c, 0))
        ptile_lo = _clamp_tile_lo(ptile_lo, max(Hb - pwr, 0),
                                  max(Wb - pwc, 0))

    return SweepPlan(
        eye01=eye01_d,
        v_grid=v_grid_d,
        u_grid=u_grid_d,
        slice_z=slice_z_d,
        seglen=seglen,
        warp_rows01=warp_rows01,
        warp_cols01=warp_cols01,
        warp_tile_lo=tile_lo,
        warp_ptile_lo=ptile_lo,
        box_range=rng_perm_d,
        box_min=box_min_d,
        axis=axis,
        sign=sign,
        perm=perm,
        coord_order=coord_order,
        identity_warp=False,
        warp_band=(band_r, band_c),
        warp_blk=warp_tile,
        pix_band=(int(pwr), int(pwc)),
        pix_blk=ptile,
    )


import os as _os

# Warp tiling defaults (base tile 96, else 64; scan unroll 8; one image
# accumulator; pixel-block granularity pb=2; pixel tile (64, 128)) were
# chosen on the first, non-GPU target and are not re-measured on the
# H100. The VOLT_WARP_* variables override them for A/B runs.
@partial(jax.jit, static_argnames=("max_r", "max_c"))
def _clamp_tile_lo(tile_lo, max_r, max_c):
    lo = jnp.minimum(tile_lo, jnp.asarray([max_r, max_c, 1], jnp.int32))
    return jnp.maximum(lo, 0)


_WARP_TILE_ENV = _os.environ.get("VOLT_WARP_TILE", "")
_WARP_UNROLL = int(_os.environ.get("VOLT_WARP_UNROLL", 8))
# Independent fwd-warp image accumulators (see _warp_windowed_fwd).
_WARP_LANES = int(_os.environ.get("VOLT_WARP_LANES", 1))
_WARP_DIV_UNROLL = bool(int(_os.environ.get("VOLT_WARP_DIV_UNROLL", "1")))


def _pick_warp_tile(Hb: int, Wb: int) -> int:
    if _WARP_TILE_ENV:
        return int(_WARP_TILE_ENV)
    if Hb % 96 == 0 and Wb % 96 == 0:
        return 96
    return 64


def _pick_pixel_tile() -> Tuple[int, int]:
    """Pixel-tile dims for the pixel-major forward warp. (64, 128) keeps
    the per-tile matmul at the base-major form's issued-flop level at the
    flagship base/pixel density (~1.4 texels/px rows, ~0.8 cols) while
    the disjoint outputs drop the image RMW. VOLT_WARP_PTILE="r,c"
    overrides for A/Bs."""
    v = _os.environ.get("VOLT_WARP_PTILE", "")
    if v:
        r, c = v.split(",")
        return (int(r), int(c))
    return (64, 128)


@partial(jax.jit,
         static_argnames=("width", "height", "aspect", "c_k", "c_a", "c_b",
                          "n_slices", "tile", "hb", "wb", "clamp_band",
                          "pb", "ptile"))
def _device_plan(packed, *, width, height, aspect, c_k, c_a, c_b,
                 n_slices, tile, hb, wb, clamp_band=None, pb=4,
                 ptile=(64, 128)):
    """Device-side plan arrays from ONE packed f32 upload: seglen map,
    pixel->base warp coords (atan space), per-pixel-tile base windows for
    the warp adjoint, and the pass-through plan vectors (so a plan build
    is one transfer + one dispatch — the serve loop builds one per
    frame). clamp_band=(band_r, band_c): clamp tile_lo in-call against a
    caller-trusted static band (skips the band readback)."""
    off = 0

    def take(n):
        nonlocal off
        v = jax.lax.slice_in_dim(packed, off, off + n)
        off += n
        return v

    right = take(3)
    up = take(3)
    forward = take(3)
    tan_half = take(1)[0]
    w2l = take(16).reshape(4, 4)
    box_range = take(3)
    th_bounds = take(4)
    rng_perm = take(3)
    eye01 = take(3)
    box_min = take(3)
    v_grid = take(hb)
    u_grid = take(wb)
    slice_z = take(n_slices)

    seglen = (1.0 / n_slices) * jnp.sqrt(
        rng_perm[0] ** 2
        + (v_grid[:, None] * rng_perm[1]) ** 2
        + (u_grid[None, :] * rng_perm[2]) ** 2)

    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    px, py = jnp.meshgrid(xs, ys, indexing="xy")
    dirs = (px[..., None] * (right * tan_half * aspect)
            + py[..., None] * (up * tan_half) + forward)
    dirs = dirs @ w2l[:3, :3].T  # slopes are scale-invariant: no normalize
    w = dirs / box_range
    u = w[..., c_b] / w[..., c_k]
    v = w[..., c_a] / w[..., c_k]
    thu_lo, thu_hi, thv_lo, thv_hi = (th_bounds[0], th_bounds[1],
                                      th_bounds[2], th_bounds[3])
    rows01 = (jnp.arctan(v) - thv_lo) / (thv_hi - thv_lo)
    cols01 = (jnp.arctan(u) - thu_lo) / (thu_hi - thu_lo)

    # Adjoint gather rects: for each (tile x tile) BASE tile, the bounding
    # PIXEL rectangle of pixels whose bilinear splat touches it. Base tiles
    # are disjoint, so the adjoint becomes independent windowed matmuls
    # reassembled by reshape — no sequential update chain and no blow-up
    # when the box footprint covers few pixels. Computed via an 8x8
    # pixel-block pre-reduction + a tiny scatter-min/max (plan-time only).
    valid = _in01(rows01) & _in01(cols01)
    nty, ntx = hb // tile, wb // tile

    def texel_range(q01, n):
        p = q01 * n - 0.5
        i0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, n - 1)
        return i0, jnp.clip(i0 + 1, 0, n - 1)

    r0, r1 = texel_range(rows01, hb)
    c0, c1 = texel_range(cols01, wb)
    # Pixel-block pre-reduction granularity: each warp rect is
    # conservative to pb pixels per edge, so smaller pb -> tighter rects
    # -> smaller band -> fewer warp flops (the warp's matmul work is
    # proportional to band area). Flagship band area: 10240 (pb=8) ->
    # 9216 (pb=4) -> 8432 (pb=2); pb=2 is the default (plan-build cost
    # is one jitted dispatch either way).
    PB = pb
    nby, nbx = -(-height // PB), -(-width // PB)
    py_pad, px_pad = nby * PB - height, nbx * PB - width

    def block_reduce(x, fill, op):
        xp = jnp.pad(jnp.where(valid, x, fill),
                     ((0, py_pad), (0, px_pad)), constant_values=fill)
        xb = xp.reshape(nby, PB, nbx, PB)
        return op(op(xb, axis=3), axis=1)  # (nby, nbx)

    big = jnp.int32(1 << 30)
    brmin = block_reduce(r0, big, jnp.min)
    brmax = block_reduce(r1, -1, jnp.max)
    bcmin = block_reduce(c0, big, jnp.min)
    bcmax = block_reduce(c1, -1, jnp.max)
    bvalid = brmax >= 0

    by = jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 0)
    bx = jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 1)
    # pixel bounds of each block (conservative to block granularity)
    py0_b, py1_b = by * PB, jnp.minimum(by * PB + PB - 1, height - 1)
    px0_b, px1_b = bx * PB, jnp.minimum(bx * PB + PB - 1, width - 1)

    tr0, tr1 = brmin // tile, brmax // tile
    tc0, tc1 = bcmin // tile, bcmax // tile
    # scatter targets padded with a dump slot for masked-out updates
    py0 = jnp.full((nty + 1, ntx + 1), big, jnp.int32)
    py1 = jnp.full((nty + 1, ntx + 1), -1, jnp.int32)
    px0 = jnp.full((nty + 1, ntx + 1), big, jnp.int32)
    px1 = jnp.full((nty + 1, ntx + 1), -1, jnp.int32)
    for dr in range(3):
        for dc in range(3):
            tr = tr0 + dr
            tc = tc0 + dc
            m = bvalid & (tr <= tr1) & (tc <= tc1)
            ti = jnp.where(m, tr, nty).ravel()
            tj = jnp.where(m, tc, ntx).ravel()
            py0 = py0.at[ti, tj].min(py0_b.ravel())
            py1 = py1.at[ti, tj].max(py1_b.ravel())
            px0 = px0.at[ti, tj].min(px0_b.ravel())
            px1 = px1.at[ti, tj].max(px1_b.ravel())
    py0, py1 = py0[:nty, :ntx], py1[:nty, :ntx]
    px0, px1 = px0[:nty, :ntx], px1[:nty, :ntx]
    nonempty = py1 >= 0
    band_r = jnp.clip(jnp.max(jnp.where(nonempty, py1 - py0 + 1, 1)),
                      1, height)
    band_c = jnp.clip(jnp.max(jnp.where(nonempty, px1 - px0 + 1, 1)),
                      1, width)
    tile_lo = jnp.stack([jnp.where(nonempty, py0, 0).ravel(),
                         jnp.where(nonempty, px0, 0).ravel(),
                         nonempty.astype(jnp.int32).ravel()], axis=-1)
    span_r = jnp.max(jnp.where(bvalid, tr1 - tr0 + 1, 1))
    span_c = jnp.max(jnp.where(bvalid, tc1 - tc0 + 1, 1))

    # Transposed rect table for the pixel-major forward warp: for each
    # (ptr x ptc) PIXEL tile, the bounding BASE-texel window of its valid
    # pixels' bilinear taps. Pixel tiles are disjoint outputs, so the
    # forward can stack + reshape instead of read-modify-writing the
    # image (the dynamic_update_slice chain the bwd splat doesn't have).
    # Exact for the same reason tile_lo is: r0/r1/c0/c1 here are the SAME
    # device f32 tap indices _tap_weights recomputes, bit for bit.
    ptr, ptc = ptile
    npr, npc = -(-height // ptr), -(-width // ptc)
    ppr_pad, ppc_pad = npr * ptr - height, npc * ptc - width

    def tile_reduce(x, fill, op):
        xp = jnp.pad(jnp.where(valid, x, fill),
                     ((0, ppr_pad), (0, ppc_pad)), constant_values=fill)
        xb = xp.reshape(npr, ptr, npc, ptc)
        return op(op(xb, axis=3), axis=1)  # (npr, npc)

    wrmin = tile_reduce(r0, big, jnp.min)
    wrmax = tile_reduce(r1, -1, jnp.max)
    wcmin = tile_reduce(c0, big, jnp.min)
    wcmax = tile_reduce(c1, -1, jnp.max)
    wactive = wrmax >= 0
    pwin_r = jnp.clip(jnp.max(jnp.where(wactive, wrmax - wrmin + 1, 1)),
                      1, hb)
    pwin_c = jnp.clip(jnp.max(jnp.where(wactive, wcmax - wcmin + 1, 1)),
                      1, wb)
    ptile_lo = jnp.stack([jnp.where(wactive, wrmin, 0).ravel(),
                          jnp.where(wactive, wcmin, 0).ravel(),
                          wactive.astype(jnp.int32).ravel()], axis=-1)

    if clamp_band is not None:
        tile_lo = jnp.maximum(
            jnp.minimum(tile_lo,
                        jnp.asarray([max(height - clamp_band[0], 0),
                                     max(width - clamp_band[1], 0), 1],
                                    jnp.int32)), 0)
        if len(clamp_band) >= 4:
            ptile_lo = jnp.maximum(
                jnp.minimum(ptile_lo,
                            jnp.asarray([max(hb - clamp_band[2], 0),
                                         max(wb - clamp_band[3], 0), 1],
                                        jnp.int32)), 0)
    return (eye01, box_min, rng_perm, v_grid, u_grid, slice_z,
            seglen, rows01, cols01, tile_lo, ptile_lo,
            jnp.stack([band_r, band_c, span_r, span_c, pwin_r, pwin_c]))


def base_rays(plan: SweepPlan):
    """World-space rays of the base grid (for oracle cross-checks): one ray
    per (v_i, u_j) base pixel, through the camera eye."""
    c_k, c_a, c_b = plan.coord_order
    Hb, Wb = plan.base_shape
    w_perm = jnp.stack(
        [jnp.broadcast_to(jnp.float32(plan.sign), (Hb, Wb)),
         plan.sign * jnp.broadcast_to(plan.v_grid[:, None], (Hb, Wb)),
         plan.sign * jnp.broadcast_to(plan.u_grid[None, :], (Hb, Wb))],
        axis=-1)
    w_xyz = jnp.zeros_like(w_perm)
    w_xyz = w_xyz.at[..., c_k].set(w_perm[..., 0])
    w_xyz = w_xyz.at[..., c_a].set(w_perm[..., 1])
    w_xyz = w_xyz.at[..., c_b].set(w_perm[..., 2])
    rng_xyz = jnp.zeros(3, jnp.float32)
    rng_xyz = rng_xyz.at[c_k].set(plan.box_range[0])
    rng_xyz = rng_xyz.at[c_a].set(plan.box_range[1])
    rng_xyz = rng_xyz.at[c_b].set(plan.box_range[2])
    d = w_xyz * rng_xyz
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    min_xyz = jnp.zeros(3, jnp.float32)
    min_xyz = min_xyz.at[c_k].set(plan.box_min[0])
    min_xyz = min_xyz.at[c_a].set(plan.box_min[1])
    min_xyz = min_xyz.at[c_b].set(plan.box_min[2])
    e01_xyz = jnp.zeros(3, jnp.float32)
    e01_xyz = e01_xyz.at[c_k].set(plan.eye01[0])
    e01_xyz = e01_xyz.at[c_a].set(plan.eye01[1])
    e01_xyz = e01_xyz.at[c_b].set(plan.eye01[2])
    o = jnp.broadcast_to(min_xyz + e01_xyz * rng_xyz, d.shape)
    return o, d


def _tap_weights(q01, n, off, tile):
    """Two-banded tap weights local to a base tile: W[p, j] is the
    bilinear weight of tap (off + j) for flattened rect pixel p (zero when
    the tap falls outside this tile — the per-tile ownership test).

    Built as the TENT function  relu(1 - |j - (clip(p) - off)|)  rather
    than two iota-equality one-hots: equal for clamp semantics at every
    point (interior: 1-f / f at floor(p) / floor(p)+1; out-of-range p
    clips to the edge texel with weight 1, exactly the clipped-two-tap
    sum; window-boundary taps drop the same out-of-window term), with
    one |.|-compare instead of two compare+select pairs per entry."""
    p = jnp.clip(q01 * n - 0.5, 0.0, float(n - 1))[:, None] - off
    iota = jnp.arange(tile, dtype=jnp.float32)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(iota - p))


def _warp_windowed_fwd(base, rows01, cols01, tile_lo, band, tile):
    """Forward warp as a scan of per-base-tile windowed matmuls — the
    exact transpose structure of _warp_bilinear_bwd's splat: each tile
    contributes  contrib[p] = sum_{a,b} R[p,a] C[p,b] tile[a,b]  to its
    plan-computed pixel rect, accumulated with dynamic_update_slice.

    The rect accumulation can stripe tiles across _WARP_LANES
    independent image accumulators (summed once at the end): a single
    carry makes every dynamic_update_slice wait on the previous one,
    while independent chains can pipeline."""
    band_r, band_c = band
    H, W = rows01.shape
    Hb, Wb, C = base.shape
    nty, ntx = Hb // tile, Wb // tile
    n_tiles = nty * ntx
    G = max(1, min(_WARP_LANES, n_tiles))
    pad_t = (-n_tiles) % G
    t_idx = jnp.arange(n_tiles, dtype=jnp.int32)
    tro = (t_idx // ntx) * tile
    tco = (t_idx % ntx) * tile
    if pad_t:
        # inactive padding entries: lo = (0, 0, active=0) gates them off
        tile_lo = jnp.concatenate(
            [tile_lo, jnp.zeros((pad_t, 3), tile_lo.dtype)], axis=0)
        tro = jnp.concatenate([tro, jnp.zeros((pad_t,), tro.dtype)])
        tco = jnp.concatenate([tco, jnp.zeros((pad_t,), tco.dtype)])

    def contrib_of(lo, ro, co):
        rr = jax.lax.dynamic_slice(
            rows01, (lo[0], lo[1]), (band_r, band_c)).reshape(-1)
        cc = jax.lax.dynamic_slice(
            cols01, (lo[0], lo[1]), (band_r, band_c)).reshape(-1)
        R = _tap_weights(rr, Hb, ro, tile)
        Cm = _tap_weights(cc, Wb, co, tile)
        tile_vals = jax.lax.dynamic_slice(base, (ro, co, 0),
                                          (tile, tile, C))
        mid = jnp.einsum("pa,abc->pbc", R, tile_vals,
                         preferred_element_type=jnp.float32)
        contrib = jnp.einsum("pbc,pb->pc", mid, Cm,
                             preferred_element_type=jnp.float32)
        # Inactive tiles (no valid pixel taps them) are gated off: their
        # rect defaults to (0, 0) and clamped out-of-footprint taps must
        # not leak into it.
        return (contrib * lo[2].astype(jnp.float32)
                ).reshape(band_r, band_c, C)

    def body(imgs, xs):
        lo, ro, co = xs
        out = []
        for g in range(G):
            contrib = contrib_of(lo[g], ro[g], co[g])
            win = jax.lax.dynamic_slice(imgs[g], (lo[g][0], lo[g][1], 0),
                                        (band_r, band_c, C))
            out.append(jax.lax.dynamic_update_slice(
                imgs[g], win + contrib, (lo[g][0], lo[g][1], 0)))
        return tuple(out), None

    imgs0 = tuple(jnp.zeros((H, W, C), jnp.float32) for _ in range(G))
    n_it = (n_tiles + pad_t) // G
    xs = (tile_lo.reshape(n_it, G, 3), tro.reshape(n_it, G),
          tco.reshape(n_it, G))
    # unroll: the per-iteration work is small (P x T matmuls); at ~576
    # tiles the scan is iteration-latency-bound without it.
    imgs, _ = jax.lax.scan(body, imgs0, xs,
                           unroll=max(1, _WARP_UNROLL // G)
                           if _WARP_DIV_UNROLL else _WARP_UNROLL)
    img = imgs[0]
    for g in range(1, G):
        img = img + imgs[g]
    return img


def _warp_pixmajor_fwd(base, rows01, cols01, ptile_lo, pix_band, pix_blk):
    """Forward warp as a scan over disjoint PIXEL tiles: each
    (ptr x ptc) pixel tile gathers its plan-computed base-texel window
    (warp_ptile_lo — the transpose of tile_lo's rects) and contracts the
    same bilinear tap weights against it; outputs stack + reshape into
    the image, so it drops the base-major forward's read-modify-write of
    overlapping image rects through dynamic_update_slice — the one
    structural cost its transpose (the bwd splat, disjoint base tiles)
    never had. Same tap math
    (_tap_weights on the same rows01/cols01 values), so results match
    the base-major form up to f32 summation order at every in-footprint
    pixel; out-of-footprint pixels differ only where the miss mask
    overwrites anyway."""
    pwr, pwc = pix_band
    ptr, ptc = pix_blk
    H, W = rows01.shape
    Hb, Wb, C = base.shape
    npr, npc = -(-H // ptr), -(-W // ptc)
    pad_r, pad_c = npr * ptr - H, npc * ptc - W
    # Padded pixels get an out-of-range coord: their taps clip to texel
    # 0 / n-1 whose window-relative index may still match — the values
    # land in the cropped margin, so correctness is unaffected.
    rp = jnp.pad(rows01, ((0, pad_r), (0, pad_c)), constant_values=-10.0)
    cp = jnp.pad(cols01, ((0, pad_r), (0, pad_c)), constant_values=-10.0)
    rp = rp.reshape(npr, ptr, npc, ptc).transpose(0, 2, 1, 3).reshape(
        npr * npc, ptr * ptc)
    cp = cp.reshape(npr, ptr, npc, ptc).transpose(0, 2, 1, 3).reshape(
        npr * npc, ptr * ptc)

    def body(carry, xs):
        lo, rr, cc = xs
        win = jax.lax.dynamic_slice(base, (lo[0], lo[1], 0), (pwr, pwc, C))
        R = _tap_weights(rr, Hb, lo[0], pwr)
        Cm = _tap_weights(cc, Wb, lo[1], pwc)
        mid = jnp.einsum("pa,abc->pbc", R, win,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("pbc,pb->pc", mid, Cm,
                         preferred_element_type=jnp.float32)
        return carry, out * lo[2].astype(jnp.float32)

    _, tiles = jax.lax.scan(body, (), (ptile_lo, rp, cp),
                            unroll=_WARP_UNROLL)
    img = tiles.reshape(npr, npc, ptr, ptc, C).transpose(0, 2, 1, 3, 4)
    return img.reshape(npr * ptr, npc * ptc, C)[:H, :W]


def _use_pixmajor(C, H, W, n_base_tiles, band, tile, pix_band, pix_blk):
    """Static chooser between the two forward-warp forms, by their
    issued-flop estimate with lane/K padding to 128 (the dominant
    cost either way; the pixel-major form additionally saves the image
    RMW, so it wins ties). VOLT_WARP_FWD forces pix/base for A/Bs."""
    mode = _os.environ.get("VOLT_WARP_FWD", "auto")
    if mode == "base" or pix_band == (0, 0):
        return False
    if mode == "pix":
        return True

    def pad128(x):
        return -(-x // 128) * 128

    est_base = (n_base_tiles * band[0] * band[1]
                * pad128(tile) * pad128(tile * C))
    n_ptiles = (-(-H // pix_blk[0])) * (-(-W // pix_blk[1]))
    est_pix = (n_ptiles * pix_blk[0] * pix_blk[1]
               * pad128(pix_band[0]) * pad128(pix_band[1] * C))
    return est_pix <= 1.25 * est_base


@partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8))
def _warp_bilinear(base, rows01, cols01, tile_lo, ptile_lo, band, tile,
                   pix_band, pix_blk):
    """Bilinear warp base (Hb, Wb, C) -> (H, W, C) at per-pixel coords.

    Forward: pixel-major scan over disjoint pixel tiles gathering base
    windows (_warp_pixmajor_fwd) when the plan carries a usable pix_band,
    else the base-major rect scan (_warp_windowed_fwd). Backward: splats
    Rtile^T @ diag(ct) @ Ctile into disjoint base tiles. Both directions
    compute the same linear bilinear-tap operator (same _tap_weights on
    the same coords), so the vjp is exact regardless of which forward
    form ran. Out-of-footprint pixels get 0/garbage — warp_base_to_pixels'
    miss mask assigns their value, and the backward contract requires
    ct == 0 there."""
    H, W = rows01.shape
    if _use_pixmajor(base.shape[-1], H, W, tile_lo.shape[0], band, tile,
                     pix_band, pix_blk):
        return _warp_pixmajor_fwd(base, rows01, cols01, ptile_lo,
                                  pix_band, pix_blk)
    return _warp_windowed_fwd(base, rows01, cols01, tile_lo, band, tile)


def _warp_bilinear_fwd(base, rows01, cols01, tile_lo, ptile_lo, band,
                       tile, pix_band, pix_blk):
    out = _warp_bilinear(base, rows01, cols01, tile_lo, ptile_lo, band,
                         tile, pix_band, pix_blk)
    return out, (base.shape, rows01, cols01, tile_lo)


def _splat_windowed(ct, rows01, cols01, tile_lo, band, tile, Hb, Wb):
    """Adjoint splat: pixel cotangents -> (Hb, Wb, C) base cotangents via
    a scan of per-tile windowed matmuls (exact transpose of
    _warp_windowed_fwd; base tiles are disjoint outputs, no races).
    Requires ct == 0 on out-of-footprint pixels."""
    band_r, band_c = band     # pixel-rect size gathered per base tile
    C = ct.shape[-1]
    nty, ntx = Hb // tile, Wb // tile
    n_tiles = nty * ntx

    t_idx = jnp.arange(n_tiles, dtype=jnp.int32)
    tro = (t_idx // ntx) * tile   # absolute base-row offset per tile
    tco = (t_idx % ntx) * tile

    def body(carry, xs):
        lo, ro, co = xs
        ctr = jax.lax.dynamic_slice(
            ct, (lo[0], lo[1], 0), (band_r, band_c, C)).reshape(-1, C)
        rr = jax.lax.dynamic_slice(
            rows01, (lo[0], lo[1]), (band_r, band_c)).reshape(-1)
        cc = jax.lax.dynamic_slice(
            cols01, (lo[0], lo[1]), (band_r, band_c)).reshape(-1)
        R = _tap_weights(rr, Hb, ro, tile)
        Cm = _tap_weights(cc, Wb, co, tile)
        M = R[:, :, None] * ctr[:, None, :]              # (P, tile, C)
        splat = jnp.einsum("pac,pb->abc", M, Cm,
                           preferred_element_type=jnp.float32)
        return carry, splat * lo[2].astype(jnp.float32)

    _, tiles = jax.lax.scan(body, (), (tile_lo, tro, tco),
                            unroll=_WARP_UNROLL)
    out = tiles.reshape(nty, ntx, tile, tile, C)
    return jnp.moveaxis(out, 1, 2).reshape(Hb, Wb, C)


def _warp_bilinear_bwd(band, tile, pix_band, pix_blk, res, ct):
    (Hb, Wb, C), rows01, cols01, tile_lo = res
    out = _splat_windowed(ct, rows01, cols01, tile_lo, band, tile, Hb, Wb)
    n_pt = ((-(-rows01.shape[0] // pix_blk[0]))
            * (-(-rows01.shape[1] // pix_blk[1])))
    return (out, jnp.zeros_like(rows01), jnp.zeros_like(cols01),
            np.zeros(tile_lo.shape, dtype=jax.dtypes.float0),
            np.zeros((n_pt, 3), dtype=jax.dtypes.float0))


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def warp_band(base, rows01, cols01, tab, band, tile):
    """Warp the FULL base (Hb, Wb, C) onto a pixel-row BAND given a
    band-local tile table (rect origins relative to the band, active
    flags pre-intersected) — the per-device piece of the sharded warp
    (parallel/sweep_sharded._finish_image_sharded). rows01/cols01 are the
    band's pixel coords; the bwd splat returns FULL base cotangents (the
    caller's all_gather transpose reduces them across devices)."""
    return _warp_windowed_fwd(base, rows01, cols01, tab, band, tile)


def _warp_band_fwd(base, rows01, cols01, tab, band, tile):
    out = warp_band(base, rows01, cols01, tab, band, tile)
    return out, (base.shape, rows01, cols01, tab)


def _warp_band_bwd(band, tile, res, ct):
    (Hb, Wb, C), rows01, cols01, tab = res
    dbase = _splat_windowed(ct, rows01, cols01, tab, band, tile, Hb, Wb)
    return (dbase, jnp.zeros_like(rows01), jnp.zeros_like(cols01),
            np.zeros(tab.shape, dtype=jax.dtypes.float0))


warp_band.defvjp(_warp_band_fwd, _warp_band_bwd)


_warp_bilinear.defvjp(_warp_bilinear_fwd, _warp_bilinear_bwd)


def warp_base_to_pixels(base_img, plan: SweepPlan, miss=None):
    """Resample base-grid maps to the actual camera pixels (bilinear,
    scatter-free custom VJP, windowed-matmul scan in plain XLA).

    The base grid is clipped to the box's slope footprint (plan_sweep), so
    pixels mapping outside it are guaranteed box misses: they get the
    per-channel `miss` value instead of clamped edge samples."""
    if plan.identity_warp:
        return base_img
    squeeze = base_img.ndim == 2
    if squeeze:
        base_img = base_img[..., None]
    out = _warp_bilinear(base_img, plan.warp_rows01, plan.warp_cols01,
                         plan.warp_tile_lo, plan.warp_ptile_lo,
                         plan.warp_band, plan.warp_blk, plan.pix_band,
                         plan.pix_blk)
    if miss is not None:
        inr = (_in01(plan.warp_rows01) & _in01(plan.warp_cols01))[..., None]
        out = jnp.where(inr, out, jnp.asarray(miss, out.dtype))
    return out[..., 0] if squeeze else out


def _in01(x):
    return (x >= 0.0) & (x <= 1.0)


def _layer_lerp(gperm, qk, depth, address_mode, layer_offset=None):
    """Fetch + lerp the two grid layers bracketing normalized sweep coord
    qk (scalar, traced). gperm: (D, A, B[, C]).

    layer_offset: global index of gperm's first layer when gperm is a
    slab-local shard of a `depth`-deep volume (parallel/sweep_sharded.py;
    the addressed layers must live in the local slab — guaranteed when
    slices sit at the slab's own voxel centers)."""
    p = qk * depth - 0.5
    i0 = jnp.floor(p)
    f = p - i0
    i0 = i0.astype(jnp.int32)
    l0 = apply_address_mode(i0, depth, address_mode)
    l1 = apply_address_mode(i0 + 1, depth, address_mode)
    if layer_offset is not None:
        local = gperm.shape[0]
        l0 = jnp.clip(l0 - layer_offset, 0, local - 1)
        l1 = jnp.clip(l1 - layer_offset, 0, local - 1)
    g0 = jax.lax.dynamic_index_in_dim(gperm, l0, 0, keepdims=False)
    g1 = jax.lax.dynamic_index_in_dim(gperm, l1, 0, keepdims=False)
    return g0 + f * (g1 - g0)


def _layer_lerp_stack(gperm, slice_z, address_mode):
    """Layer-lerp the (D, A, B[, C]) volume onto the S slice planes:
    out[s] = volume sampled at normalized sweep coord slice_z[s] (same
    texel-center lerp as _layer_lerp). Differentiable — voxel gradients
    chain through the take/lerp. The sharded sweep uses it when
    n_slices != depth: each device then sweeps the pre-lerped stack,
    whose slices are by construction at its own layer centers."""
    depth = gperm.shape[0]
    p = slice_z * depth - 0.5
    i0f = jnp.floor(p)
    fb = (p - i0f).astype(jnp.float32)
    i0 = i0f.astype(jnp.int32)
    l0 = apply_address_mode(i0, depth, address_mode)
    l1 = apply_address_mode(i0 + 1, depth, address_mode)
    fb = fb.reshape((-1,) + (1,) * (gperm.ndim - 1))
    g0 = jnp.take(gperm, l0, axis=0)
    g1 = jnp.take(gperm, l1, axis=0)
    return g0 + fb * (g1 - g0)


_NCH = 4  # reference-combine channels (frag.glsl:63-71)


def _channel_offsets(medium, scroll, coord_order):
    """Per-channel scroll offsets in (k, a, b) coord order (traced)."""
    c_k, c_a, c_b = coord_order
    offs = []
    for c in range(_NCH):
        if scroll is None:
            offs.append((jnp.float32(0.0),) * 3)
        else:
            o = scroll[c] * medium.channel_scroll_weight[c]
            offs.append((o[c_k], o[c_a], o[c_b]))
    return offs


def _layer_channels(gperm4, slice_z, medium, offs, address_mode):
    """XLA precompute: for every slice s and channel c, the layer-lerped
    2D slab of channel c at k-coord z_s*scale_c + offk_c (the sweep-axis
    third of the trilinear sample, frag.glsl:66-69). Returns (S, C, A, B);
    differentiable, so autodiff carries dL -> dgrid through the lerp."""
    depth = gperm4.shape[0]
    chans = []
    for c in range(_NCH):
        qk = slice_z * medium.channel_coord_scale[c] + offs[c][0]
        p = qk * depth - 0.5
        i0 = jnp.floor(p)
        f = (p - i0).astype(jnp.float32)[:, None, None]
        i0 = i0.astype(jnp.int32)
        l0 = apply_address_mode(i0, depth, address_mode)
        l1 = apply_address_mode(i0 + 1, depth, address_mode)
        g = gperm4[..., c]
        chans.append(jnp.take(g, l0, axis=0) * (1.0 - f)
                     + jnp.take(g, l1, axis=0) * f)
    return jnp.stack(chans, axis=1)


def _resample_slice(g2d, a01, b01, address_mode, dtype):
    """Wa @ g2d @ Wb^T via ops/resample.py — two dense matmuls.

    The weight matrices are sweep geometry (camera/plan), never a
    differentiation target: stop_gradient keeps autodiff from emitting the
    (equally large) cotangent matmuls against them in the backward pass."""
    A, B = g2d.shape
    Wa = jax.lax.stop_gradient(
        linear_resample_matrix(a01, A, address_mode, dtype))
    Wb = jax.lax.stop_gradient(
        linear_resample_matrix(b01, B, address_mode, dtype))
    t = jnp.dot(Wa, g2d.astype(dtype), preferred_element_type=jnp.float32)
    return jnp.dot(t.astype(dtype), Wb.T.astype(dtype),
                   preferred_element_type=jnp.float32)


def _sigma_general(gperm, z_s, a01_base, b01_base, plan, medium, scroll,
                   address_mode, dtype, depth_total=None, layer_offset=None):
    """Per-slice extinction for any combine mode / coord scale / scroll.

    Mirrors ops/integrate.sample_sigma (frag.glsl:63-71) with trilinear
    sampling decomposed as layer-lerp (sweep axis) x separable bilinear
    (slice plane). depth_total/layer_offset support slab-local gperm
    shards (sharded sweep)."""
    depth = depth_total if depth_total is not None else gperm.shape[0]
    c_k, c_a, c_b = plan.coord_order
    if medium.combine == "reference":
        if layer_offset is not None:
            raise NotImplementedError(
                "sharded sweep supports combine='single' media (scaled/"
                "scrolled channel coords may cross slab boundaries); the "
                "sharded renderer pre-lerps channels instead "
                "(chan_slabs)")

        def lerped_channel(c):
            if scroll is not None:
                off_k = (scroll[c] * medium.channel_scroll_weight[c])[c_k]
            else:
                off_k = 0.0
            sc = medium.channel_coord_scale[c]
            return _layer_lerp(gperm[..., c], z_s * sc + off_k, depth,
                               address_mode)

        return _combine_reference_inplane(lerped_channel, a01_base,
                                          b01_base, plan, medium, scroll,
                                          address_mode, dtype)
    elif medium.combine == "single":
        g = gperm[..., 0] if gperm.ndim == 4 else gperm
        g = _layer_lerp(g, z_s, depth, address_mode, layer_offset)
        r = _resample_slice(g, a01_base, b01_base, address_mode, dtype)
        return r * medium.sample_scale
    raise ValueError(f"unknown combine mode {medium.combine!r}")


def _combine_reference_inplane(channel_slab, a01_base, b01_base, plan,
                               medium, scroll, address_mode, dtype):
    """The reference combine's in-plane half, shared by the unsharded and
    sharded sigma paths: per channel, separable resample of its (already
    sweep-axis-lerped) 2D slab at scaled/scrolled coords, then
    (s1*s2)*(s3+s4)*scale (frag.glsl:63-71). channel_slab(c) -> (A, B)."""
    c_k, c_a, c_b = plan.coord_order
    samples = []
    for c in range(4):
        sc = medium.channel_coord_scale[c]
        if scroll is not None:
            off = scroll[c] * medium.channel_scroll_weight[c]
            off_a, off_b = off[c_a], off[c_b]
        else:
            off_a = off_b = 0.0
        samples.append(_resample_slice(
            channel_slab(c), a01_base * sc + off_a, b01_base * sc + off_b,
            address_mode, dtype))
    s1, s2, s3, s4 = samples
    return (s1 * s2) * (s3 + s4) * medium.sample_scale


def _sigma_from_channel_slabs(chan_s, a01_base, b01_base, plan, medium,
                              scroll, address_mode, dtype):
    """Reference-combine extinction for one slice from PRE-LERPED channel
    slabs chan_s (C, A, B) — the sweep-axis third of each channel's
    trilinear sample already applied (_layer_channels). Only the in-plane
    separable resample remains, which is slab-local — this is what makes
    the reference combine shardable (the cross-slab k-gather moved into
    the XLA precompute, where GSPMD handles it)."""
    return _combine_reference_inplane(lambda c: chan_s[c], a01_base,
                                      b01_base, plan, medium, scroll,
                                      address_mode, dtype)


@jax.named_scope("sweep_base")
def _sweep_base(
    gperm,
    lperm,
    slice_z,
    v_grid,
    u_grid,
    seglen,
    plan: SweepPlan,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig],
    scroll,
    chunk: Optional[int] = None,
    depth_total=None,
    layer_offset=None,
    chan_slabs=None,
    lperm_depth=None,
    lperm_offset=None,
):
    """Front-to-back composited base maps (acc, trans, wsum, hit) over an
    explicit slice subset and base-grid subset.

    `wsum` is the scalar emission weight sum (per-slice trans*alpha*shade
    accumulated); the light COLOR is constant per frame, so color =
    wsum[..., None] * light.color exactly — keeping the maps scalar
    halves the warp and carry traffic vs carrying RGB
    (finish_image applies the color).

    This is the sweep's inner engine: sweep_render passes the full plan
    arrays; the sharded renderer (parallel/sweep_sharded.py) passes each
    device's local slab slices and base-row block — the compositing carry
    is an associative monoid, so slab partials combine exactly afterwards.

    Memory: two-level checkpointed scan keeps backward residuals at
    O(sqrt(S) * base image) instead of O(S * base image).
    """
    dtype = cfg.jnp_dtype
    Hb = v_grid.shape[0]
    Wb = u_grid.shape[0]
    e_k, e_a, e_b = plan.eye01[0], plan.eye01[1], plan.eye01[2]

    emission = cfg.emission
    lt = light if light is not None else LightConfig()
    S = slice_z.shape[0]

    # Chunked two-level scan: outer scan stores only per-chunk carries;
    # inner chunk is rematerialized in the backward pass.
    if chunk is None:
        chunk = max(1, int(round(math.sqrt(S))))
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    # Padding slices sit behind the eye (delta * sign < 0) -> masked no-ops.
    if pad:
        sentinel = jnp.full((pad,), plan.eye01[0] - plan.sign, jnp.float32)
        slice_z = jnp.concatenate([slice_z, sentinel])
        if chan_slabs is not None:
            chan_slabs = jnp.concatenate(
                [chan_slabs, jnp.zeros((pad,) + chan_slabs.shape[1:],
                                       chan_slabs.dtype)])
    slice_z = slice_z.reshape(n_chunks, chunk)
    if chan_slabs is not None:
        chan_slabs = chan_slabs.reshape((n_chunks, chunk)
                                        + chan_slabs.shape[1:])

    def one_slice(carry, xs):
        z_s, chan_s = xs
        acc, trans, wsum, hit = carry
        delta = z_s - e_k
        a01 = e_a + delta * v_grid   # (Hb,)
        b01 = e_b + delta * u_grid   # (Wb,)
        front = (delta * plan.sign) > 0.0
        mask = (_in01(a01)[:, None] & _in01(b01)[None, :] & front)
        maskf = mask.astype(jnp.float32)
        if chan_s is not None:
            sigma = _sigma_from_channel_slabs(chan_s, a01, b01, plan,
                                              medium, scroll,
                                              cfg.address_mode, dtype)
        else:
            sigma = _sigma_general(gperm, z_s, a01, b01, plan, medium,
                                   scroll, cfg.address_mode, dtype,
                                   depth_total, layer_offset)
        sigma = sigma * maskf
        if emission:
            # Early-termination parity with the oracle (a masked no-op on
            # already-opaque pixels; matches integrate.py's `active` gate).
            # Under slab sharding `trans` is slab-LOCAL, and the gate's
            # eps-truncation error bound still holds — see the contract
            # note in parallel/sweep_sharded.py.
            live = (trans > cfg.early_stop_transmittance).astype(jnp.float32)
            alpha = live * (
                1.0 - jnp.exp(-medium.density * sigma * seglen))
            if lperm is not None:
                # lperm_depth/lperm_offset: lperm may be a slab-LOCAL
                # block of a depth-lperm_depth light stack (sharded
                # sweep) — same contract as gperm's layer_offset.
                lT = _layer_lerp(lperm, z_s,
                                 lperm_depth or lperm.shape[0],
                                 cfg.address_mode, lperm_offset)
                lT = _resample_slice(lT, a01, b01, cfg.address_mode, dtype)
                shade = lt.ambient + (1.0 - lt.ambient) * jnp.clip(
                    lT, 0.0, 1.0)
            else:
                shade = 1.0
            wsum = wsum + trans * alpha * shade
            trans = trans * (1.0 - alpha)
        else:
            acc = acc + sigma * seglen
            hit = jnp.maximum(hit, maskf)
        return (acc, trans, wsum, hit), None

    @jax.checkpoint
    def one_chunk(carry, xs):
        # Unrolled inner loop: XLA sees straight-line code per chunk and
        # keeps the compositing carry out of HBM between slices (the carry
        # round-trip, not the matmuls, would otherwise dominate bandwidth).
        return jax.lax.scan(one_slice, carry, xs, unroll=True)

    init = (jnp.zeros((Hb, Wb), jnp.float32),
            jnp.ones((Hb, Wb), jnp.float32),
            jnp.zeros((Hb, Wb), jnp.float32),
            jnp.zeros((Hb, Wb), jnp.float32))
    (acc, trans, wsum, hit), _ = jax.lax.scan(one_chunk, init,
                                              (slice_z, chan_slabs))
    return acc, trans, wsum, hit


def composite_base_maps(near, far):
    """Front-to-back combination of two composited base-map tuples — the
    associative monoid that makes slab sharding exact:
    C = C_near + T_near * C_far, T = T_near * T_far (and acc/hit are
    sum/max). This is how rays crossing slab boundaries are handled
    without any per-ray carry exchange (SURVEY.md section 5.7)."""
    acc1, t1, w1, h1 = near
    acc2, t2, w2, h2 = far
    return (acc1 + acc2,
            t1 * t2,
            w1 + t1 * w2,
            jnp.maximum(h1, h2))


def warp_inputs(base_maps, cfg: RenderConfig):
    """The two scalar maps the warp transports, and their miss values."""
    acc, trans, wsum, hit = base_maps
    if cfg.emission:
        return jnp.stack([wsum, trans], axis=-1), (0.0, 1.0)
    return jnp.stack([acc, hit], axis=-1), (0.0, 0.0)


def postwarp_pixels(out, cfg: RenderConfig, medium: MediumConfig,
                    light: Optional[LightConfig] = None):
    """Per-pixel nonlinearities after the warp: color = wsum * light
    color (exact — the light color is constant), Beer-Lambert display
    transform for the absorption mode."""
    background = jnp.asarray(cfg.background, jnp.float32)
    if cfg.emission:
        lt = light if light is not None else LightConfig()
        lcol = jnp.asarray(lt.color, jnp.float32)
        rgb = out[..., 0:1] * lcol + out[..., 1:2] * background
        alpha = 1.0 - out[..., 1]
    else:
        gray = 1.0 - jnp.exp(-medium.density * out[..., 0])
        hitp = jnp.clip(out[..., 1], 0.0, 1.0)
        rgb = (gray[..., None] * hitp[..., None]
               + background * (1.0 - hitp[..., None]))
        alpha = hitp
    return jnp.concatenate([rgb, alpha[..., None]], axis=-1)


@jax.named_scope("warp")
def finish_image(base_maps, plan: SweepPlan, cfg: RenderConfig,
                 medium: MediumConfig,
                 light: Optional[LightConfig] = None):
    """Warp the *linear* base quantities to screen pixels, then apply the
    per-pixel nonlinearities (the bilinear warp commutes with every linear
    post-op; exp/where do not). Only TWO scalar maps are warped in the
    emission path — (wsum, trans) — and color = wsum * light.color is
    formed per pixel afterwards (exact: the light color is a constant)."""
    base, miss = warp_inputs(base_maps, cfg)
    out = warp_base_to_pixels(base, plan, miss=miss)
    return postwarp_pixels(out, cfg, medium, light)


def sweep_render(
    grid,
    plan: SweepPlan,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    light_volume=None,
    chunk: Optional[int] = None,
):
    """Render one RGBA frame (H, W, 4) by sweeping slices front-to-back.

    grid: (D, H, W) or (D, H, W, C) density volume in [0,1].
    light_volume: optional precomputed per-voxel light transmittance grid
    (same spatial shape), sampled at each step for shading (config 4's
    nested light march, computed once per frame by a second sweep — see
    ops/lighting.py).
    """
    squeeze_c = grid.ndim == 3
    gperm = jnp.transpose(grid, plan.perm + ((3,) if not squeeze_c else ()))
    lperm = (jnp.transpose(light_volume, plan.perm)
             if light_volume is not None else None)
    base_maps = _sweep_base(gperm, lperm, plan.slice_z, plan.v_grid,
                            plan.u_grid, plan.seglen, plan, cfg, medium,
                            light, scroll, chunk)
    return finish_image(base_maps, plan, cfg, medium, light=light)
