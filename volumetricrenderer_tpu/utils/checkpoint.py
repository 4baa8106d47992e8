"""Checkpoint / resume — absent in the reference (its scene is regenerated
from noise seeds each run, TestMain.cpp:59-62; nothing is ever saved). The
equivalent here (SURVEY.md section 5.4): save/restore density grid +
optimizer state + step counter so a preempted multi-host fit resumes, with
deterministic seed-driven regeneration kept as the fast path.

Format: numpy .npz + a JSON metadata sidecar, written atomically via
temp-file rename (preemption-safe). A deliberately dependency-free format:
checkpoints here are a single dense grid + small optimizer pytree, so a
hierarchical checkpointing library would add surface without capability.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _flatten(tree) -> Dict[str, np.ndarray]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}, treedef


def save_checkpoint(directory: str, step: int, grid, opt_state=None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write checkpoint for `step` under directory. Returns the path.

    Layout: <dir>/ckpt_<step>.npz + <dir>/ckpt_<step>.json (metadata).
    Atomic via temp-file rename (preemption-safe)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    arrays = {"grid": np.asarray(grid)}
    if opt_state is not None:
        flat, _ = _flatten(opt_state)
        arrays.update({f"opt_{k}": v for k, v in flat.items()})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "extra": extra or {}}
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name[len("ckpt_"):-len(".npz")])
        for name in os.listdir(directory)
        if name.startswith("ckpt_") and name.endswith(".npz")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       opt_state_template=None):
    """Restore (step, grid, opt_state, extra). step=None -> latest.

    opt_state_template: a pytree with the target structure (e.g. a freshly
    initialized optimizer state) whose leaves are replaced by saved values;
    None skips optimizer restore."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        grid = data["grid"]
        opt_state = None
        if opt_state_template is not None:
            leaves, treedef = jax.tree_util.tree_flatten(opt_state_template)
            restored = [
                data[f"opt_leaf_{i}"] if f"opt_leaf_{i}" in data else leaves[i]
                for i in range(len(leaves))
            ]
            opt_state = jax.tree_util.tree_unflatten(treedef, restored)
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    extra = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            extra = json.load(f).get("extra", {})
    return step, grid, opt_state, extra
