"""Proof that the renderer's main path runs on an NVIDIA GPU.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --multi         # four cards: config 5 sharded only
    python chip_smoke.py --trace DIR     # one card: flagship fwd+bwd under
                                         # the profiler, split by layer
                                         # (CUDA graphs off, so the split
                                         # sees each kernel)

Phases, in one JAX process (the serve self-test uses threads of it):

  device   JAX must report a GPU; there is no CPU fallback.
  cli      the user entry points through volumetricrenderer_tpu.cli.main:
           render config4 (256^3 FBM cloud, emission-absorption, light-
           volume shadows) at 1920x1080; render the 4-channel reference
           preset at 1280x720; animate 8 orbit frames of config4 (compiled
           executables must equal plan signatures); fit a 256^3 grid to a
           1024^2 image for 4 steps (loss finite and falling); serve 16
           frames of config2 over HTTP.
  parity   the sweep against the per-ray oracle ops/integrate.
           render_rays_sliced: the config4 base image at 256^3 with the
           1080p plan, the reference preset's base image at 1280x720, and
           the voxel gradient at 256^3 with a 960x540 plan. Under
           "highest" matmul precision they are held to the CPU suite's
           tolerances; at the program's default precision (TF32 matmuls
           on this card) to the bounds stated at DEFAULT_FWD_ATOL.
  timing   compile seconds and steady ms (host clock around
           block_until_ready) of the config4 frame forward, forward+
           backward, light sweep, base-map sweep and warp; the fwd+bwd
           step's memory analysis and the device's peak bytes in use.

Any failure raises, so the exit code is nonzero. Every line names the card
and its power limit. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import socket
import sys
import time

if "--trace" in sys.argv:
    # One command buffer (CUDA graph) per step would hide every kernel
    # behind one trace event, so the layer split needs them launched
    # singly. XLA reads its flags when the backend starts, which importing
    # the package below already does.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")

import jax
import jax.numpy as jnp
import numpy as np

from volumetricrenderer_tpu import cli
from volumetricrenderer_tpu.config import get_preset
from volumetricrenderer_tpu.models.scene import build_volume
from volumetricrenderer_tpu.ops.camera import make_camera
from volumetricrenderer_tpu.ops.integrate import (reference_media_scroll,
                                                  render_rays_sliced)
from volumetricrenderer_tpu.ops.lighting import light_transmittance_volume
from volumetricrenderer_tpu.ops.sweep import (_sweep_base, base_rays,
                                              finish_image, plan_sweep,
                                              sweep_render)
from volumetricrenderer_tpu.render import render_image
from volumetricrenderer_tpu.utils.compile_cache import enable_compile_cache
from volumetricrenderer_tpu.utils.clock import compile_and_time
from volumetricrenderer_tpu.utils.device import (card_description,
                                                 require_gpu)

# Tolerances under jax.default_matmul_precision("highest"): the CPU
# suite's (tests/test_sweep.py base image; bench.py voxel gradient).
HIGHEST_FWD = dict(rtol=2e-5, atol=2e-5)
HIGHEST_GRAD_REL = 1e-3
# At the default precision the sweep's f32 matmuls may run in TF32, which
# rounds each operand to 10 mantissa bits (relative error <= 2^-11). A
# sample's extinction passes through two resample matmuls, so its relative
# error is at most ~4 * 2^-11 ~ 2e-3; an error of that relative size in
# the optical depth tau moves a transmittance by at most
# max(tau * exp(-tau)) * 2e-3 ~ 7e-4, and the colour and alpha by the same
# order. Forward pixels are held to 5e-3 absolute (about 7x that bound).
# The backward adds two TF32 matmuls per slice (the transposed resample)
# on top of the recomputed forward, so the voxel gradient is held to
# 2e-2 of its largest magnitude.
DEFAULT_FWD_ATOL = 5e-3
DEFAULT_GRAD_REL = 2e-2

CARD = "card unknown"
DEVICE_PLANE = "/device:GPU"  # profiler planes that hold the card's ops
# The CLI phase's images, metrics and checkpoints (gitignored).
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")


def say(msg):
    print(f"[{CARD}] {msg}", flush=True)


# --- cli phase --------------------------------------------------------------

def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                               "big")


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed_main(argv):
    t0 = time.perf_counter()
    rc = cli.main(argv)
    assert rc == 0, f"cli {argv[0]} returned {rc}"
    return time.perf_counter() - t0


def cli_phase(out):
    for preset in ("config4", "reference"):
        cam = get_preset(preset).camera
        w, h = cam.width, cam.height
        png = os.path.join(out, f"{preset}.png")
        argv = ["render", "--preset", preset, "--out", png]
        first = _timed_main(argv)
        second = _timed_main(argv)
        assert _png_size(png) == (w, h), _png_size(png)
        say(f"cli render {preset} {w}x{h}: written {png}; first call "
            f"{first:.1f} s (compile included), second {second*1e3:.1f} ms")

    anim = os.path.join(out, "animate")
    _timed_main(["animate", "--preset", "config4", "--orbit", "--frames",
                 "8", "--out-dir", anim])
    rows = _metrics(os.path.join(anim, "metrics.jsonl"))
    frames = [r["seconds"] for r in rows if "frame" in r]
    counts = [r for r in rows if "n_compiles" in r][-1]
    assert len(frames) == 8, len(frames)
    assert counts["n_compiles"] == counts["n_signatures"], counts
    say(f"cli animate config4 orbit 8 frames: {counts['n_compiles']} "
        f"compiled executables == {counts['n_signatures']} plan "
        f"signatures; seconds per frame (a frame with a new signature "
        f"compiles): {', '.join(f'{t:.3f}' for t in frames)}")

    fit = os.path.join(out, "fit")
    secs = _timed_main(["fit", "--size", "256", "--image-size", "1024",
                        "--steps", "4", "--out-dir", fit])
    losses = [r["loss"] for r in _metrics(os.path.join(fit, "metrics.jsonl"))
              if "loss" in r]
    assert len(losses) >= 2 and np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    say(f"cli fit 256^3 / 1024^2, 4 steps: loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g} (finite, falling); {secs:.1f} s in all")

    report = os.path.join(out, "serve.json")
    _timed_main(["serve", "--preset", "config2", "--selftest-frames", "16",
                 "--port", str(_free_port()), "--selftest-out", report])
    with open(report) as f:
        served = json.load(f)
    assert served["frames"] == 16, served
    say(f"cli serve config2 {served['width']}x{served['height']}: 16 "
        f"frames answered; warm-up "
        f"{served['warmup_s']} s (compile included), "
        f"{served['ms_per_frame']} ms/frame, "
        f"{served['n_executables']} executable(s)")


# --- parity phase -----------------------------------------------------------

def flagship(width=1920, height=1080, size=256):
    """config4's volume, render, medium and light at a camera size."""
    p = get_preset("config4")
    grid = jax.block_until_ready(jax.jit(build_volume, static_argnums=0)(
        dataclasses.replace(p.volume, size=size)))
    cam = make_camera(dataclasses.replace(p.camera, width=width,
                                          height=height))
    plan = plan_sweep(cam, grid.shape, p.render,
                      supersample=p.render.sweep_supersample)
    return p, grid, plan


def reference_case(width=1280, height=720, size=128):
    p = get_preset("reference")
    grid = jax.block_until_ready(jax.jit(build_volume, static_argnums=0)(
        dataclasses.replace(p.volume, size=size)))
    cfg = dataclasses.replace(p.render, quadrature="sliced")
    cam = make_camera(dataclasses.replace(p.camera, width=width,
                                          height=height))
    plan = plan_sweep(cam, grid.shape[:3], cfg,
                      supersample=cfg.sweep_supersample)
    return cfg, p.medium, p.light, grid, plan


def _errors(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(err.max()), float(np.percentile(err, 99))


def forward_parity(name, grid, plan, cfg, medium, light=None, scroll=None,
                   light_volume=None):
    """Base image of the sweep vs the oracle on the base rays, at highest
    and at default matmul precision. Returns the error lines."""
    o, d = base_rays(plan)
    oracle = jax.jit(lambda g, lv, o, d, p: render_rays_sliced(
        g, o, d, p, cfg, medium, light, scroll=scroll, light_volume=lv))
    want = np.asarray(oracle(grid, light_volume, o, d, plan))
    ip = dataclasses.replace(plan, identity_warp=True)
    sweep = lambda g, lv, p: sweep_render(g, p, cfg, medium, light,  # noqa
                                          scroll=scroll, light_volume=lv)
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(jax.jit(sweep)(grid, light_volume, ip))
    lo = np.asarray(jax.jit(sweep)(grid, light_volume, ip))
    assert np.isfinite(hi).all() and np.isfinite(lo).all()
    hi_max, hi_p99 = _errors(hi, want)
    lo_max, lo_p99 = _errors(lo, want)
    np.testing.assert_allclose(hi, want, **HIGHEST_FWD, err_msg=name)
    assert lo_max <= DEFAULT_FWD_ATOL, (name, lo_max)
    say(f"parity fwd {name} base {plan.base_shape}: highest max "
        f"{hi_max:.3e} p99 {hi_p99:.3e} (rtol=atol=2e-5 ok); default "
        f"max {lo_max:.3e} p99 {lo_p99:.3e} (<= {DEFAULT_FWD_ATOL} ok)")


def grad_parity(grid, plan, cfg, medium, light, light_volume):
    o, d = base_rays(plan)
    ip = dataclasses.replace(plan, identity_warp=True)

    def loss_sweep(g, lv, p):
        img = sweep_render(g, p, cfg, medium, light, light_volume=lv)
        return jnp.sum(img[..., :3] ** 2)

    def loss_oracle(g, lv, o, d, p):
        img = render_rays_sliced(g, o, d, p, cfg, medium, light,
                                 light_volume=lv)
        return jnp.sum(img[..., :3] ** 2)

    want = np.asarray(jax.jit(jax.grad(loss_oracle))(grid, light_volume, o,
                                                     d, plan))
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(jax.jit(jax.grad(loss_sweep))(grid, light_volume,
                                                      ip))
    lo = np.asarray(jax.jit(jax.grad(loss_sweep))(grid, light_volume, ip))
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(hi).all() and np.isfinite(lo).all()
    hi_max, hi_p99 = _errors(hi, want)
    lo_max, lo_p99 = _errors(lo, want)
    np.testing.assert_allclose(hi, want, rtol=HIGHEST_GRAD_REL,
                               atol=HIGHEST_GRAD_REL * scale)
    assert lo_max <= DEFAULT_GRAD_REL * scale, (lo_max, scale)
    say(f"parity voxel grad {grid.shape[0]}^3 base {plan.base_shape}: "
        f"max|g| {scale:.3e}; highest max {hi_max:.3e} p99 {hi_p99:.3e} "
        f"(rtol 1e-3, atol 1e-3*max|g| ok); default max {lo_max:.3e} "
        f"p99 {lo_p99:.3e} (<= {DEFAULT_GRAD_REL}*max|g| ok)")


def parity_phase(size=256, fwd_px=(1920, 1080), grad_px=(960, 540),
                 ref_px=(1280, 720), ref_size=128):
    p, grid, plan = flagship(*fwd_px, size=size)
    lv = jax.jit(lambda g: light_transmittance_volume(
        g, p.light, p.render, p.medium))(grid)
    forward_parity(f"config4 {size}^3 {fwd_px[0]}x{fwd_px[1]}", grid, plan,
                   p.render, p.medium, p.light, light_volume=lv)
    cfg, medium, light, rgrid, rplan = reference_case(*ref_px, size=ref_size)
    forward_parity(f"reference {ref_size}^3x4 {ref_px[0]}x{ref_px[1]} "
                   f"t=1.0", rgrid, rplan, cfg, medium, light,
                   scroll=reference_media_scroll(1.0))
    gcam = make_camera(dataclasses.replace(p.camera, width=grad_px[0],
                                           height=grad_px[1]))
    gplan = plan_sweep(gcam, grid.shape, p.render,
                       supersample=p.render.sweep_supersample)
    grad_parity(grid, gplan, p.render, p.medium, p.light, lv)


# --- timing phase -----------------------------------------------------------

def flagship_fns(p):
    cfg, medium, light = p.render, p.medium, p.light

    def frame(g, plan):
        return render_image(g, None, cfg, medium, light, plan=plan,
                            backend="sweep")

    def loss(g, plan):
        return jnp.sum(frame(g, plan)[..., :3] ** 2)

    def light_sweep(g):
        return light_transmittance_volume(g, light, cfg, medium)

    def base_sweep(g, lv, plan):
        perm = plan.perm + ((3,) if g.ndim == 4 else ())
        return _sweep_base(jnp.transpose(g, perm),
                           jnp.transpose(lv, plan.perm), plan.slice_z,
                           plan.v_grid, plan.u_grid, plan.seglen, plan, cfg,
                           medium, light, None)

    def warp(maps, plan):
        return finish_image(maps, plan, cfg, medium, light=light)

    return dict(frame=frame, fwd_bwd=jax.value_and_grad(loss),
                light_sweep=light_sweep, base_sweep=base_sweep, warp=warp)


def timing_phase(device):
    p, grid, plan = flagship()
    fns = flagship_fns(p)
    tag = f"config4 {grid.shape[0]}^3 {plan.warp_rows01.shape[1]}x" \
          f"{plan.warp_rows01.shape[0]}"
    _, img, c, s = compile_and_time(fns["frame"], grid, plan)
    assert img.shape == plan.warp_rows01.shape + (4,)
    assert bool(jnp.isfinite(img).all())
    say(f"timing {tag} forward frame: compile {c:.1f} s, {s*1e3:.3f} ms")
    step, (val, g), c, s = compile_and_time(fns["fwd_bwd"], grid, plan)
    assert bool(jnp.isfinite(val)) and bool(jnp.isfinite(g).all())
    say(f"timing {tag} forward+backward: compile {c:.1f} s, "
        f"{s*1e3:.3f} ms/frame, {plan.warp_rows01.size / s / 1e6:.2f} "
        f"M rays/s")
    _, lv, c, s = compile_and_time(fns["light_sweep"], grid)
    say(f"timing {tag} light sweep: compile {c:.1f} s, {s*1e3:.3f} ms")
    _, maps, c, s = compile_and_time(fns["base_sweep"], grid, lv, plan)
    say(f"timing {tag} base-map sweep (fwd): compile {c:.1f} s, "
        f"{s*1e3:.3f} ms")
    _, _, c, s = compile_and_time(fns["warp"], maps, plan)
    say(f"timing {tag} warp + post-warp (fwd): compile {c:.1f} s, "
        f"{s*1e3:.3f} ms")
    mem = step.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    say("timing fwd+bwd memory_analysis: " + ", ".join(
        f"{f} {getattr(mem, f)}" for f in fields if hasattr(mem, f)))
    stats = device.memory_stats() or {}
    say(f"timing peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return p, grid, plan, fns


# --- trace (option) ---------------------------------------------------------

def _op_names(compiled):
    """HLO instruction name -> op_name metadata of a compiled step."""
    import re
    pat = re.compile(r'%?([\w.\-]+) = .*metadata=\{op_name="([^"]*)"')
    out = {}
    for line in compiled.as_text().splitlines():
        m = pat.search(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _layer(op_name):
    for scope in ("light_sweep", "sweep_base", "warp"):
        if scope in op_name:
            part = scope
            break
    else:
        part = "other"
    return part + (" bwd" if "transpose(" in op_name else " fwd")


def trace_phase(device, trace_dir, iters=5):
    """Trace `iters` flagship fwd+bwd steps and split the device time by
    layer (named scopes light_sweep / sweep_base / warp, backward where
    the op comes from a transpose) and into busy and idle."""
    import glob
    p, grid, plan = flagship()
    fn = flagship_fns(p)["fwd_bwd"]
    step = jax.jit(fn).lower(grid, plan).compile()
    jax.block_until_ready(step(grid, plan))
    names = _op_names(step)
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            jax.block_until_ready(step(grid, plan))
    window_ns = (time.perf_counter() - t0) * 1e9
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    split, kernels, spans = {}, {}, []
    for plane in data.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op", ev.name)
                if "hlo_op" not in stats and op not in names:
                    continue  # not an XLA op (memcpy, runtime markers)
                part = _layer(names.get(op, ""))
                split[part] = split.get(part, 0.0) + ev.duration_ns
                kernels[op] = kernels.get(op, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    assert spans, "the trace holds no device op"
    spans.sort()
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    first, last = spans[0][0], max(b for _, b in spans)
    say(f"trace fwd+bwd x{iters}: device busy {busy / iters / 1e6:.3f} "
        f"ms/step, idle share {1 - busy / (last - first):.4f} of the "
        f"device span ({window_ns / iters / 1e6:.3f} ms/step host window)")
    for part, ns in sorted(split.items(), key=lambda kv: -kv[1]):
        say(f"trace split {part}: {ns / iters / 1e6:.3f} ms/step "
            f"({ns / sum(split.values()):.3f} of kernel time)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    for op, ns in top:
        say(f"trace kernel {op} [{_layer(names.get(op, ''))}]: "
            f"{ns / iters / 1e6:.3f} ms/step")
    with open(os.path.join(trace_dir, "split.json"), "w") as f:
        json.dump({"card": CARD, "iters": iters,
                   "split_ns_per_step": {k: v / iters
                                         for k, v in split.items()},
                   "busy_ns_per_step": busy / iters,
                   "top_kernels_ns_per_step": {k: v / iters
                                               for k, v in top}}, f)


# --- four cards (option) ----------------------------------------------------

def multi_phase(devices, train_size=128, train_px=(960, 540)):
    """config5 (512^3, 1920x1080) through sweep_render_sharded on (data,
    slab) meshes of four cards, each against the unsharded render on one
    card; then one make_sweep_train_step step on a (2, 2) mesh against the
    same step on a 1x1 mesh, on config5's cloud at train_size^3 and
    train_px (a smaller step keeps its two compilations short)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from volumetricrenderer_tpu.parallel.mesh import make_mesh
    from volumetricrenderer_tpu.parallel.sweep_sharded import (
        make_sweep_train_step, sweep_render_sharded)

    assert len(devices) >= 4, f"--multi needs 4 cards, found {len(devices)}"
    p = get_preset("config5")
    # The slab-local early-exit gate differs from the global one by
    # O(eps) (parallel/sweep_sharded.py); parity runs with it off.
    cfg = dataclasses.replace(p.render, early_stop_transmittance=-1.0)
    medium, light = p.medium, p.light
    grid = jax.block_until_ready(jax.jit(build_volume, static_argnums=0)(
        p.volume))
    plan = plan_sweep(make_camera(p.camera), grid.shape, cfg,
                      supersample=cfg.sweep_supersample)
    tag = (f"config5 {grid.shape[0]}^3 {p.camera.width}x{p.camera.height} "
           f"base {plan.base_shape}")
    _, want, c, s = compile_and_time(
        lambda g, pl: sweep_render(g, pl, cfg, medium, light), grid, plan)
    want = np.asarray(want)
    say(f"multi {tag} unsharded on 1 card: compile {c:.1f} s, "
        f"{s*1e3:.3f} ms/frame")
    for data, slab in ((1, 4), (2, 2), (4, 1)):
        mesh = make_mesh(data=data, slab=slab, devices=devices[:4])
        gs = jax.device_put(grid, NamedSharding(mesh, P("slab")))
        _, got, c, s = compile_and_time(
            lambda g, pl, m=mesh: sweep_render_sharded(g, pl, m, cfg,
                                                       medium, light),
            gs, plan)
        # Both renders run at the default precision (TF32 operands) and
        # group their f32 sums differently (slab partials, other matmul
        # tilings), so they are held to the TF32 forward bound; the
        # train step below checks the sharded path under "highest".
        err, p99 = _errors(got, want)
        n_big = int((np.abs(np.asarray(got) - want) > 2e-4).sum())
        assert err <= DEFAULT_FWD_ATOL, (data, slab, err)
        say(f"multi {tag} mesh (data {data}, slab {slab}): compile "
            f"{c:.1f} s, {s*1e3:.3f} ms/frame; vs unsharded max {err:.3e} "
            f"p99 {p99:.3e} (<= {DEFAULT_FWD_ATOL} ok; {n_big} of "
            f"{want.size} values differ by more than 2e-4)")

    grid = jax.block_until_ready(jax.jit(build_volume, static_argnums=0)(
        dataclasses.replace(p.volume, size=train_size)))
    cam = make_camera(dataclasses.replace(p.camera, width=train_px[0],
                                          height=train_px[1]))
    plan = plan_sweep(cam, grid.shape, cfg,
                      supersample=cfg.sweep_supersample)
    target = jax.jit(lambda g, pl: sweep_render(
        g, pl, cfg, medium, light)[..., :3])(grid, plan)
    g0 = jnp.clip(grid * 0.8, 0.0, 1.0)
    results = {}
    for name, shape in (("1x1", (1, 1)), ("2x2", (2, 2))):
        mesh = make_mesh(data=shape[0], slab=shape[1],
                         devices=devices[:shape[0] * shape[1]])
        step, opt = make_sweep_train_step(mesh, plan, cfg, medium, light)
        # a copy: the step donates its grid
        g = jax.device_put(jnp.copy(g0), NamedSharding(mesh, P("slab")))
        t = jax.device_put(target, NamedSharding(mesh, P("data")))
        st = opt.init(g)
        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            g_new, st_new, loss = step(g, st, t)
        jax.block_until_ready(g_new)
        first = time.perf_counter() - t0
        # Adam's first moment after one step is (1 - b1) * grad.
        mu = jax.tree.leaves(st_new)[1]
        results[name] = (float(loss), np.asarray(mu) / 0.1, first)
        say(f"multi train step {name} {train_size}^3 {train_px[0]}x"
            f"{train_px[1]}: loss {float(loss):.6g}, first step "
            f"{first:.1f} s (compile included)")
    (l1, g1, _), (l2, g2, _) = results["1x1"], results["2x2"]
    scale = float(np.abs(g1).max())
    gerr = float(np.abs(g2 - g1).max())
    assert np.isfinite(l2) and abs(l2 - l1) <= 1e-3 * abs(l1), (l1, l2)
    assert scale > 0 and gerr <= 1e-3 * scale, (gerr, scale)
    say(f"multi train step 2x2 vs 1x1 (\"highest\" precision): loss "
        f"{l2:.6g} vs {l1:.6g}; voxel grad max err {gerr:.3e} of max|g| "
        f"{scale:.3e} (<= 1e-3 ok)")


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card config5 sharded phase")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="run only the traced flagship fwd+bwd split")
    args = ap.parse_args(argv)

    enable_compile_cache()
    devices = require_gpu()
    dev = devices[0]
    CARD = card_description()
    say(f"device: platform {dev.platform}, kind {dev.device_kind}, count "
        f"{len(devices)}; nvidia-smi name, power.limit: {CARD}")
    t_start = time.perf_counter()
    if args.multi:
        multi_phase(devices)
    elif args.trace:
        trace_phase(dev, args.trace)
    else:
        shutil.rmtree(OUT_DIR, ignore_errors=True)
        os.makedirs(OUT_DIR)
        cli_phase(OUT_DIR)
        parity_phase()
        timing_phase(dev)
    say(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
