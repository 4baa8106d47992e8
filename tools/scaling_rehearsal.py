"""Config-5 rehearsal: run the sharded sweep train step on the virtual
8-device CPU mesh across mesh shapes and record per-shape timing + status
to a JSON artifact.

CPU timings model no interconnect and no device speed — the artifact's
purpose is (a) proof that the full sharded train step compiles and runs
at a non-trivial size on every mesh shape, and (b) a relative sanity
check that adding slab/data ways does not explode step time (collective
overhead stays bounded). Device scaling numbers need the cards.

Usage: python tools/scaling_rehearsal.py  (env: V=128 IMG=512 STEPS=2
OUT=scaling_rehearsal.json)
"""
import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from volumetricrenderer_tpu.config import (CameraConfig, MediumConfig,  # noqa: E402
                                           RenderConfig)
from volumetricrenderer_tpu.models.scene import cloud_volume  # noqa: E402
from volumetricrenderer_tpu.ops.camera import make_camera  # noqa: E402
from volumetricrenderer_tpu.ops.sweep import plan_sweep, sweep_render  # noqa: E402
from volumetricrenderer_tpu.parallel.mesh import make_mesh  # noqa: E402
from volumetricrenderer_tpu.parallel.sweep_sharded import (  # noqa: E402
    make_sweep_train_step, sweep_render_sharded)

V = int(os.environ.get("V", 128))
IMG = int(os.environ.get("IMG", 512))
STEPS = int(os.environ.get("STEPS", 2))
OUT = os.environ.get("OUT", "scaling_rehearsal.json")
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def main():
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = RenderConfig(emission=True, quadrature="sliced")
    medium = MediumConfig(combine="single", density=8.0)
    cam = make_camera(CameraConfig(width=IMG, height=IMG))
    grid = cloud_volume(V, seed=7)
    plan = plan_sweep(cam, grid.shape, cfg)
    target = sweep_render(grid, plan, cfg, medium)[..., :3]
    print(f"rehearsal: {V}^3 grid, {IMG}x{IMG}, base {plan.base_shape}",
          file=sys.stderr, flush=True)

    rows = []
    for data, slab in SHAPES:
        mesh = make_mesh(data=data, slab=slab)
        # fwd-only render per shape: attributes any train-step asymmetry
        # between the forward sweep/composite/warp and the backward pass
        # (e.g. a slab-heavy vs data-heavy asymmetry).
        fwd = jax.jit(lambda g, m=mesh: sweep_render_sharded(
            g, plan, m, cfg, medium))
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(grid))
        fwd_compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(STEPS):
            out = fwd(grid)
        jax.block_until_ready(out)
        fwd_ms = (time.perf_counter() - t0) / STEPS * 1e3
        step, optimizer = make_sweep_train_step(mesh, plan, cfg, medium,
                                                learning_rate=5e-2)
        g = jax.device_put(jnp.full_like(grid, 0.4),
                           NamedSharding(mesh, P("slab")))
        st = optimizer.init(g)
        tgt = jax.device_put(target, NamedSharding(mesh, P("data")))
        t0 = time.perf_counter()
        g, st, loss = jax.block_until_ready(step(g, st, tgt))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(STEPS):
            g, st, loss = step(g, st, tgt)
        jax.block_until_ready(loss)
        per_step = (time.perf_counter() - t0) / STEPS
        rows.append({"mesh": {"data": data, "slab": slab},
                     "ms_per_step": round(per_step * 1e3, 1),
                     "fwd_render_ms": round(fwd_ms, 1),
                     "compile_s": round(compile_s, 1),
                     "fwd_compile_s": round(fwd_compile_s, 1),
                     "final_loss": float(loss)})
        print(f"  mesh {data}x{slab}: {per_step*1e3:.0f} ms/step "
              f"(compile {compile_s:.0f}s, loss {float(loss):.5f})",
              file=sys.stderr, flush=True)

    artifact = {
        "what": "config-5 rehearsal: sharded fwd+bwd train step on the "
                "8-device CPU mesh (correctness/compile rehearsal; not an "
                "ICI performance model)",
        "volume": V, "image": IMG, "base_shape": list(plan.base_shape),
        "steps_timed": STEPS, "shapes": rows,
    }
    with open(OUT, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))


if __name__ == "__main__":
    main()
