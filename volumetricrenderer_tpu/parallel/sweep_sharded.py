"""Multi-device slice-sweep rendering and training (BASELINE config 5).

Distribution of the sweep over a (data, slab) mesh, in renderer terms
(SURVEY.md sections 5.7-5.9):

  * slab (SP/CP + TP-analogue): the volume is sharded along the *sweep*
    axis; each device sweeps only its own slab's slices with a local
    `lax.scan`. Because front-to-back compositing is an associative
    monoid ((C,T): C = C1 + T1*C2, T = T1*T2 — ops/sweep.py
    composite_base_maps), rays crossing slab boundaries need no per-ray
    carry exchange: each device produces a partial base image and the
    partials combine in closed form by a log2(n_slab)-step ppermute
    butterfly over the monoid (_composite_slabs; per device log2(n)
    base-map tuples moved and log2(n) combines, vs an all_gather's
    n-1 and n-1 — at 1536^2 f32 that is ~38 MB x log2(n) per device).
    This replaces a hand-written ring-carry pipeline — XLA hands the
    collectives to the interconnect and can overlap them with the warp.
  * data (DP): base-image rows shard over "data" (each device builds
    resample matrices only for its own v-rows), and screen-pixel rows
    shard over "data" for the warp/loss, via GSPMD sharding constraints.
  * Ulysses-analogue resharding: the grid arrives sharded along grid-z
    (storage layout); rendering re-shards the *transposed* volume so
    slabs align with the camera's sweep axis — one all-to-all per frame
    instead of per-slice halo traffic.

Voxel-gradient all-reduce falls out of autodiff: the transpose of the
slab all_gather is a reduce-scatter, and XLA overlaps it with the
backward sweep.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LightConfig, MediumConfig, RenderConfig
from ..ops.sweep import (SweepPlan, _channel_offsets, _in01,
                         _layer_channels, _layer_lerp_stack, _sweep_base,
                         composite_base_maps, finish_image, postwarp_pixels,
                         warp_band, warp_inputs)
from .mesh import DATA_AXIS, SLAB_AXIS

__all__ = ["sweep_render_sharded", "make_sweep_train_step"]


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _composite_slabs(base, n_slab, sign):
    """Every-device front-to-back composite of the per-slab partial base
    maps over the slab axis.

    Power-of-two slab counts run a recursive-doubling butterfly over the
    associative (NON-commutative) monoid (ops/sweep.composite_base_maps):
    after step s each device holds the composite of its aligned
    2^(s+1)-slab range, so log2(n) ppermute exchanges of one base-map
    tuple replace an all_gather of n tuples + replicated O(n)
    sequential fold — per device: log2(n) map-tuples
    received and log2(n) combines, vs n-1 and n-1. Front-to-back order is
    by slab rank along the sweep direction (rank = device index, flipped
    when rays travel toward -k); non-commutativity is honored by choosing
    the operand order per device from its rank bit. Non-power-of-two slab
    counts keep the gather+fold.

    Differentiable: ppermute's transpose is the inverse permute, so the
    voxel-gradient flow back across slabs falls out of autodiff."""
    if n_slab == 1:
        return base
    if n_slab & (n_slab - 1):  # not a power of two: gather + ordered fold
        parts = jax.lax.all_gather(base, SLAB_AXIS)
        order = list(range(n_slab) if sign > 0
                     else range(n_slab - 1, -1, -1))
        out = jax.tree.map(lambda x: x[order[0]], parts)
        for i in order[1:]:
            out = composite_base_maps(out, jax.tree.map(lambda x: x[i],
                                                        parts))
        return out
    idx = jax.lax.axis_index(SLAB_AXIS)
    rank = idx if sign > 0 else (n_slab - 1) - idx  # front-to-back rank
    out = base
    step = 1
    while step < n_slab:
        perm = [(i, i ^ step) for i in range(n_slab)]
        other = jax.tree.map(
            lambda x: jax.lax.ppermute(x, SLAB_AXIS, perm), out)
        near_mine = (rank & step) == 0  # scalar bool, broadcasts in where
        ab = composite_base_maps(out, other)   # mine in front
        ba = composite_base_maps(other, out)   # mine behind
        out = jax.tree.map(lambda x, y: jnp.where(near_mine, x, y), ab, ba)
        step *= 2
    return out


def sweep_render_sharded(
    grid,
    plan: SweepPlan,
    mesh: Mesh,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    scroll=None,
    chunk=None,
    light_volume=None,
):
    """Sharded sweep_render: grid slab-sharded, base rows + screen rows
    data-sharded. Returns the full (H, W, 4) image (pixel rows sharded
    over "data").

    Requirements (static): plan.base_shape[0] % data == 0 and
    len(plan.slice_z) % slab == 0 (base dims are multiples of 64 and the
    default slice count is the grid depth, so power-of-two meshes divide
    them).

    n_slices != depth: the reference
    caps its march at 128 steps for ANY volume (frag.glsl:30), so
    sub-voxel-count slicing is its honest quadrature at 512^3. The
    volume is layer-lerped onto the S slice planes in plain XLA
    (_layer_lerp_stack — differentiable, GSPMD inserts the cross-slab
    gathers) and the LERPED stack is slab-sharded, exactly as the
    reference-combine channel slabs already were; each device then
    sweeps slices at its local stack's own centers.

    combine="reference" (frag.glsl:63-71): the per-channel scaled/scrolled
    k-coordinates cross slab boundaries, so the sweep-axis layer-lerp is
    hoisted OUT of shard_map into plain XLA (_layer_channels) where GSPMD
    inserts the cross-slab gathers; each device then sweeps its local
    pre-lerped (S_loc, 4, A, B) block — in-plane work is slab-local.

    light_volume: optional per-voxel
    light-transmittance grid (ops/lighting.py, BASELINE config 4's
    shadows). Pre-lerped onto the slice planes outside shard_map (same
    differentiable stack treatment as the grid) and slab-sharded; each
    device shades its own slices. Gradients flow to it.
    """
    n_slab = mesh.shape[SLAB_AXIS]
    squeeze_c = grid.ndim == 3
    gperm = jnp.transpose(grid, plan.perm + ((3,) if not squeeze_c else ()))
    depth_total = gperm.shape[0]
    S = plan.slice_z.shape[0]
    if S % n_slab:
        raise ValueError("sharded sweep needs slab | n_slices")
    combine_ref0 = medium.combine == "reference"
    prelerp = (not combine_ref0) and S != depth_total
    if light_volume is not None and light_volume.shape != grid.shape[:3]:
        raise ValueError("light_volume must match the grid's spatial "
                         "shape")
    lperm = (jnp.transpose(light_volume, plan.perm)
             if light_volume is not None else None)
    # Ulysses-analogue reshard: slabs along the sweep axis.
    gperm = jax.lax.with_sharding_constraint(
        gperm, NamedSharding(mesh, P(SLAB_AXIS)))
    # Early exit under slab sharding: the gate runs on *slab-local*
    # transmittance. This is the same epsilon-truncation contract as the
    # unsharded gate — skipping once local T < eps changes this slab's
    # partial by < eps, and the monoid composite scales that by the prefix
    # transmittance (<= 1), so total error stays < eps. What it cannot
    # capture is work wasted in BACK slabs hidden by front slabs (their
    # local T starts at 1); recovering that would require pipelining slabs
    # front-to-back (serializing the slab axis) or a gathered prefix gate
    # with the same dependency — the measured waste is bounded by the
    # fraction of saturated rays times (n_slab-1)/n_slab and is the price
    # of full slab parallelism.
    cfg_local = cfg

    # Shard the slice set in *k order* so each device sweeps exactly the
    # slices of its own layer block; front-to-back then means: flip the
    # local block when rays travel toward -k, and fold slab partials in
    # device order (sign > 0) or reversed (sign < 0).
    slice_z_k = plan.slice_z if plan.sign > 0 else plan.slice_z[::-1]

    combine_ref = combine_ref0
    lerped_k = None
    if combine_ref:
        if gperm.ndim != 4 or gperm.shape[-1] < 4:
            raise ValueError("reference combine needs a (D, H, W, 4) grid")
        offs = _channel_offsets(medium, scroll, plan.coord_order)
        lerped_k = _layer_channels(gperm, slice_z_k, medium, offs,
                                   cfg.address_mode)  # (S, 4, A, B) k order
        lerped_k = jax.lax.with_sharding_constraint(
            lerped_k, NamedSharding(mesh, P(SLAB_AXIS)))
    elif prelerp:
        # Sub-voxel quadrature: lerp the volume onto the S slice planes
        # (k order) in XLA, then slab-shard the LERPED stack — the
        # single-channel twin of the reference-combine chan_slabs path.
        gperm = _layer_lerp_stack(gperm, slice_z_k, cfg.address_mode)
        gperm = jax.lax.with_sharding_constraint(
            gperm, NamedSharding(mesh, P(SLAB_AXIS)))
    if combine_ref:
        # The channel slabs replace the grid inside shard_map (the raw
        # grid's depth need not divide the slab axis when S != depth).
        gp_in, grid_spec = None, None
    else:
        gp_in = gperm
        grid_spec = (P(SLAB_AXIS) if gperm.ndim == 3
                     else P(SLAB_AXIS, None, None, None))
    lv_k = None
    if lperm is not None:
        # Light stack in k order at the slice planes (identity-exact when
        # slices sit at voxel centers); sharded like the grid stack. The
        # lerp is differentiable, so dL/dlight_volume chains through.
        lv_k = _layer_lerp_stack(lperm, slice_z_k, cfg.address_mode)
        lv_k = jax.lax.with_sharding_constraint(
            lv_k, NamedSharding(mesh, P(SLAB_AXIS)))

    # The effective sweep depth each device sees: local slices sit at the
    # local (lerped or raw) stack's own layer centers in every mode.
    depth_eff = S

    def local_sweep(gp, chan, lv, slice_z, v_grid, seglen):
        s_loc = S // n_slab
        slab_i = jax.lax.axis_index(SLAB_AXIS)
        layer_offset = slab_i * s_loc
        slice_local = slice_z if plan.sign > 0 else slice_z[::-1]
        chan_local = None
        if chan is not None:
            chan_local = chan if plan.sign > 0 else chan[::-1]
        base = _sweep_base(gp, lv, slice_local, v_grid, plan.u_grid,
                           seglen, plan, cfg_local, medium, light,
                           scroll, chunk, depth_total=depth_eff,
                           layer_offset=layer_offset,
                           chan_slabs=chan_local,
                           lperm_depth=depth_eff,
                           lperm_offset=layer_offset)
        return _composite_slabs(base, n_slab, plan.sign)

    chan_spec = P(SLAB_AXIS, None, None, None) if combine_ref else None
    lv_spec = P(SLAB_AXIS, None, None) if lv_k is not None else None
    base_maps = _shard_map(
        local_sweep, mesh,
        in_specs=(grid_spec, chan_spec, lv_spec, P(SLAB_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                   P(DATA_AXIS, None), P(DATA_AXIS, None)),
    )(gp_in, lerped_k, lv_k, slice_z_k, plan.v_grid, plan.seglen)

    return _finish_image_sharded(base_maps, plan, mesh, cfg, medium, light)


def _finish_image_sharded(base_maps, plan, mesh, cfg, medium, light):
    """finish_image with the windowed warp run per-device: each device
    all-gathers the (small) base maps over "data" and warps them onto its
    own pixel-row band, scanning only its own band-clipped tile rects —
    no cross-device traffic inside the 576-iteration tile scan (leaving
    the scan to GSPMD would put the collective inside every iteration).
    The gather's autodiff transpose reduce-scatters the base cotangents;
    the band warp itself is ops/sweep.warp_band (custom_vjp, exact
    transpose). Falls back to the GSPMD full-image path when the pixel
    rows don't divide into bands that can hold a tile rect."""
    H, W = plan.warp_rows01.shape
    n_data = mesh.shape[DATA_AXIS]
    band_r, band_c = plan.warp_band
    if H % n_data or H // n_data < band_r:
        img = finish_image(base_maps, plan, cfg, medium, light=light)
        return jax.lax.with_sharding_constraint(
            img, NamedSharding(mesh, P(DATA_AXIS)))
    H_loc = H // n_data
    base, miss = warp_inputs(base_maps, cfg)
    base = jax.lax.with_sharding_constraint(
        base, NamedSharding(mesh, P(DATA_AXIS)))

    def local(base_rows, rows01, cols01):
        full = jax.lax.all_gather(base_rows, DATA_AXIS, axis=0, tiled=True)
        d = jax.lax.axis_index(DATA_AXIS)
        band_lo = d * H_loc
        lo = plan.warp_tile_lo
        inter = ((lo[:, 0] < band_lo + H_loc)
                 & (lo[:, 0] + band_r > band_lo)
                 & (lo[:, 2] > 0))
        lo0 = jnp.clip(lo[:, 0] - band_lo, 0, H_loc - band_r)
        tab = jnp.stack([lo0, lo[:, 1], inter.astype(jnp.int32)], axis=-1)
        out = warp_band(full, rows01, cols01, tab, plan.warp_band,
                        plan.warp_blk)
        inr = (_in01(rows01) & _in01(cols01))[..., None]
        out = jnp.where(inr, out, jnp.asarray(miss, out.dtype))
        return postwarp_pixels(out, cfg, medium, light)

    img = _shard_map(
        local, mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None, None),
    )(base, plan.warp_rows01, plan.warp_cols01)
    return img


def make_sweep_train_step(mesh: Mesh, plan: SweepPlan, cfg: RenderConfig,
                          medium: MediumConfig,
                          light: Optional[LightConfig] = None,
                          optimizer=None, learning_rate: float = 1e-2):
    """Jitted sharded inverse-rendering step over the mesh.

    step(grid, opt_state, target) -> (grid, opt_state, loss) with the grid
    (and its Adam moments) slab-sharded and the target image row-sharded.
    The voxel-gradient reduce over "data" and the slab-boundary composite
    transpose come from GSPMD/shard_map autodiff, not hand-written
    collectives."""
    import optax

    if optimizer is None:
        optimizer = optax.adam(learning_rate)

    gs = NamedSharding(mesh, P(SLAB_AXIS))
    ts = NamedSharding(mesh, P(DATA_AXIS))

    use_shadow = (light is not None and light.shadow_steps > 0
                  and cfg.emission)

    def loss_fn(grid, target):
        lv = None
        if use_shadow:
            # Config-4 shadows under the mesh: the light sweep is plain
            # XLA (a scan of (A, B) matmuls, O(volume) total) computed
            # under GSPMD outside shard_map; differentiable, so the
            # gradient chains through the shadow field too.
            from ..ops.lighting import light_transmittance_volume
            lv = light_transmittance_volume(grid, light, cfg, medium)
        img = sweep_render_sharded(grid, plan, mesh, cfg, medium, light,
                                   light_volume=lv)
        return jnp.mean((img[..., :3] - target) ** 2)

    @functools.partial(
        jax.jit,
        in_shardings=(gs, None, ts),
        out_shardings=(gs, None, None),
        donate_argnums=(0, 1),
    )
    def step(grid, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(grid, target)
        updates, opt_state = optimizer.update(grads, opt_state, grid)
        grid = optax.apply_updates(grid, updates)
        grid = jnp.clip(grid, 0.0, 1.0)
        return grid, opt_state, loss

    return step, optimizer
