"""Inverse rendering — fit a density grid to target images by gradient
descent through the renderer (BASELINE config 3's "inverse-render fit").

The reference is forward-only (no backward pass exists anywhere in its
tree); differentiability is this framework's core extension. The fit loop
is the "train()" of this domain: each step renders, computes image loss,
backpropagates to voxel densities, and applies an optax update, optionally
sharded over a device mesh (rays = data axis, voxel grads all-reduced).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax

from .config import LightConfig, MediumConfig, RenderConfig
from .ops.camera import Camera, camera_rays
from .ops.integrate import render_rays
from .utils.metrics import MetricsWriter, get_logger

__all__ = ["FitResult", "fit_grid"]


@dataclasses.dataclass
class FitResult:
    grid: jnp.ndarray
    losses: list
    steps: int
    skipped_steps: int = 0  # steps the NaN guard refused to apply


def fit_grid(
    target_rgb,
    camera: Camera,
    cfg: RenderConfig,
    medium: MediumConfig,
    light: Optional[LightConfig] = None,
    grid_size: int = 64,
    steps: int = 200,
    learning_rate: float = 5e-2,
    init_grid=None,
    metrics: Optional[MetricsWriter] = None,
    checkpoint_fn: Optional[Callable] = None,
    checkpoint_every: int = 0,
    init_opt_state=None,
    start_step: int = 0,
    nan_guard: bool = True,
) -> FitResult:
    """Fit a single-channel density grid so the rendered image matches
    target_rgb (H, W, 3). Returns the fitted grid and the loss history.

    checkpoint_fn(step, grid, opt_state), when given with
    checkpoint_every > 0, is the periodic-checkpoint hook (failure
    recovery — SURVEY.md section 5.3/5.4). To resume a preempted fit,
    pass init_grid/init_opt_state/start_step from
    utils.checkpoint.restore_checkpoint (the CLI's `fit --resume` does);
    steps counts total steps, so a resumed run executes steps-start_step
    more and matches an uninterrupted run exactly (Adam state included).

    With quadrature="sliced" the loss differentiates through the
    slice-sweep (ops/sweep.py) — the production path; "fixed" keeps the
    reference-parity gather integrator."""
    target = jnp.asarray(target_rgb, jnp.float32)

    if init_grid is None:
        grid = jnp.full((grid_size,) * 3, 0.1, jnp.float32)
    else:
        grid = jnp.asarray(init_grid, jnp.float32)

    optimizer = optax.adam(learning_rate)
    if init_opt_state is not None:
        opt_state = jax.tree.map(jnp.asarray, init_opt_state)
    else:
        opt_state = optimizer.init(grid)

    if cfg.quadrature == "sliced":
        from .ops.sweep import plan_sweep, sweep_render
        plan = plan_sweep(camera, grid.shape, cfg,
                          supersample=cfg.sweep_supersample)

        def loss_fn(g):
            img = sweep_render(g, plan, cfg, medium, light)
            return jnp.mean((img[..., :3] - target) ** 2)
    else:
        origins, directions = camera_rays(camera)

        def loss_fn(g):
            img = render_rays(g, origins, directions, cfg, medium, light)
            return jnp.mean((img[..., :3] - target) ** 2)

    @jax.jit
    def step_fn(g, st):
        loss, grads = jax.value_and_grad(loss_fn)(g)
        if nan_guard:
            # NaN-step skip (SURVEY.md §5.3 elastic recovery): a step whose
            # loss or gradients are non-finite applies NO update — grid and
            # optimizer state pass through unchanged, so one corrupt batch/
            # shard cannot poison the Adam moments.
            ok = jnp.isfinite(loss) & jnp.all(jnp.isfinite(grads))
            grads = jnp.where(ok, grads, jnp.zeros_like(grads))
            updates, st_new = optimizer.update(grads, st, g)
            g_new = jnp.clip(optax.apply_updates(g, updates), 0.0, 1.0)
            g = jnp.where(ok, g_new, g)
            st = jax.tree.map(lambda a, b: jnp.where(ok, a, b), st_new, st)
            return g, st, loss, ok
        updates, st = optimizer.update(grads, st, g)
        g = optax.apply_updates(g, updates)
        return jnp.clip(g, 0.0, 1.0), st, loss, jnp.bool_(True)

    log = get_logger()
    losses = []
    if start_step >= steps:
        # Resuming a completed fit (the CLI checkpoints at step == steps):
        # nothing left to do.
        log.info("fit already complete at step %d/%d", start_step, steps)
        return FitResult(grid=grid, losses=losses, steps=steps)
    skipped = 0
    for i in range(start_step, steps):
        grid, opt_state, loss, ok = step_fn(grid, opt_state)
        losses.append(float(loss))
        if not bool(ok):
            skipped += 1
            log.warning("fit step %d skipped: non-finite loss/gradients "
                        "(loss=%r)", i, float(loss))
        if metrics is not None and (i % 10 == 0 or i == steps - 1):
            metrics.write(step=i, loss=float(loss))
        if checkpoint_fn and checkpoint_every and (i + 1) % checkpoint_every == 0:
            checkpoint_fn(i + 1, grid, opt_state)
    if skipped:
        log.warning("fit: %d/%d steps skipped by the NaN guard", skipped,
                    steps - start_step)
    log.info("fit finished: %d steps, loss %.6f -> %.6f",
             steps - start_step, losses[0], losses[-1])
    return FitResult(grid=grid, losses=losses, steps=steps,
                     skipped_steps=skipped)
