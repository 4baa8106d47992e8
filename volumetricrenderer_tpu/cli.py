"""Command-line entry point — the headless equivalent of the reference's
interactive demo loop (TestMain.cpp:173-256: poll keys, update MVP +
MediaScroll from the clock, render, present). On a headless accelerator
host there is no window; the loop becomes an animation renderer writing
PNG frames, plus subcommands for single frames, inverse-render fits, a
live HTTP viewer, and info.

Usage:
  python -m volumetricrenderer_tpu render  --preset config2 --out frame.png
  python -m volumetricrenderer_tpu animate --preset config2 --frames 48 \
      --orbit --out-dir frames/
  python -m volumetricrenderer_tpu fit     --size 32 --steps 100 \
      --out-dir fit_run/
  python -m volumetricrenderer_tpu info
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _add_common(p):
    p.add_argument("--preset", default="config1",
                   help="named BASELINE preset (config1..config5, reference)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "sweep", "reference"],
                   help='"sweep" = slice-sweep, "reference" = per-ray '
                        "jnp oracle, auto = sweep when supported")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--volume-size", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace (Perfetto/TensorBoard) "
                        "of the render to this directory (SURVEY §5.1)")
    p.add_argument("--check-nan", action="store_true",
                   help="run under checkify float checks: abort with the "
                        "failing primitive on any NaN/Inf (the sanitizer "
                        "build analogue, SURVEY §5.2)")


class _MaybeProfile:
    """jax.profiler.trace context when a directory is given, no-op else."""

    def __init__(self, profile_dir):
        self.dir = profile_dir

    def __enter__(self):
        if self.dir:
            import jax
            self._t = jax.profiler.trace(self.dir)
            self._t.__enter__()
        return self

    def __exit__(self, *exc):
        if self.dir:
            return self._t.__exit__(*exc)
        return False


def _resolve_preset(args):
    from .config import get_preset
    try:
        p = get_preset(args.preset)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        raise SystemExit(2)
    if args.width or args.height:
        cam = dataclasses.replace(
            p.camera,
            width=args.width or p.camera.width,
            height=args.height or p.camera.height)
        p = dataclasses.replace(p, camera=cam)
    if args.volume_size:
        p = dataclasses.replace(
            p, volume=dataclasses.replace(p.volume, size=args.volume_size))
    return p


def cmd_render(args):
    import jax

    from .render import render_preset
    from .utils.clock import Clock
    from .utils.image import write_png
    from .utils.metrics import get_logger

    preset = _resolve_preset(args)
    clock = Clock()
    def do_render(t):
        return render_preset(preset, t=t, backend=args.backend)
    if args.check_nan:
        from .utils.sanitize import checked
        do_render = checked(do_render)
    with _MaybeProfile(args.profile_dir):
        img = jax.block_until_ready(do_render(args.time))
    dt = clock.stamp()
    write_png(args.out, img)
    rays = preset.camera.width * preset.camera.height
    get_logger().info("rendered %s %dx%d in %.3fs (%.2f Mrays/s) -> %s",
                      preset.name, preset.camera.width, preset.camera.height,
                      dt, rays / dt / 1e6, args.out)
    return 0


def animation_plans(cameras, grid_shape, cfg):
    """Compile-stable sweep plans for an animated camera path: probe every
    frame's natural base dims (host-only), force the max onto all frames,
    and unify the warp band — so all frames sharing an (axis, sign) reuse
    ONE jit executable instead of recompiling per frame (the reference's
    60 fps interactive loop, TestMain.cpp:173-256, is the parity bar).
    Returns (plans, n_signatures)."""
    from .ops.sweep import (plan_base_dims, plan_signature, plan_sweep,
                            with_warp_band)
    dims = [plan_base_dims(c, grid_shape, cfg,
                           supersample=cfg.sweep_supersample)
            for c in cameras]
    fh = max(d[0] for d in dims)
    fw = max(d[1] for d in dims)
    plans = [plan_sweep(c, grid_shape, cfg,
                        supersample=cfg.sweep_supersample,
                        force_base_dims=(fh, fw))
             for c in cameras]
    band = (max(p.warp_band[0] for p in plans),
            max(p.warp_band[1] for p in plans),
            0 if any(p.pix_band[0] == 0 for p in plans)
            else max(p.pix_band[0] for p in plans),
            0 if any(p.pix_band[1] == 0 for p in plans)
            else max(p.pix_band[1] for p in plans))
    plans = [with_warp_band(p, band) for p in plans]
    return plans, len({plan_signature(p) for p in plans})


def cmd_animate(args):
    import jax

    from .models.scene import build_volume
    from .ops.camera import make_camera, orbit_camera
    from .ops.integrate import reference_media_scroll
    from .render import render_image
    from .utils.clock import Clock
    from .utils.image import write_png
    from .utils.metrics import MetricsWriter, get_logger

    preset = _resolve_preset(args)
    os.makedirs(args.out_dir, exist_ok=True)
    medium = preset.medium
    if preset.scene:
        # Multi-volume preset (config 3): bake the scene once via the
        # SAME helper render_scene uses (incl. reference-combine
        # materialization) — the same preset must show the same content
        # under `render` and `animate`.
        from .models import scene as scene_mod
        from .render import prepare_baked_scene
        volumes = getattr(scene_mod, preset.scene)(preset.volume.size)
        grid, medium, _ = prepare_baked_scene(volumes, preset.render,
                                              medium)
    else:
        grid = build_volume(preset.volume)
    n_ch = grid.shape[-1] if grid.ndim == 4 else 1
    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl"))
    log = get_logger()

    def camera_at(i):
        if args.orbit:
            import math
            return orbit_camera(2 * math.pi * i / args.frames,
                                fov_y_degrees=preset.camera.fov_y_degrees,
                                width=preset.camera.width,
                                height=preset.camera.height)
        return make_camera(preset.camera)

    cfg, light = preset.render, preset.light
    sliced = cfg.quadrature == "sliced" and args.backend in ("auto", "sweep")
    plans = [None] * args.frames
    frame_fn = None
    if sliced:
        cams = [camera_at(i) for i in range(args.frames)]
        try:
            plans, n_sigs = animation_plans(cams, grid.shape, cfg)
        except ValueError as e:
            # One wide-FOV/diagonal frame must not abort the animation:
            # match render_image's loud per-frame gather fallback instead.
            log.warning(
                "no sweep axis for at least one animation frame (%s); "
                "falling back to the unplanned per-frame path — expect a "
                "slowdown", e)
            sliced = False
    if sliced:
        log.info("animation: %d frames share %d executable(s)",
                 args.frames, n_sigs)

        use_shadow = light is not None and light.shadow_steps > 0

        @jax.jit
        def frame_fn(g, plan, scroll):
            lv = None
            if use_shadow and cfg.emission:
                from .ops.lighting import light_transmittance_volume
                # scroll must reach the shadow sweep too — reference-
                # combine shadows track the scrolling media exactly as
                # render_image's path does
                lv = light_transmittance_volume(g, light, cfg, medium,
                                                scroll=scroll)
            img = render_image(g, None, cfg, medium, light, scroll=scroll,
                               plan=plan, light_volume=lv,
                               backend="sweep")
            # uint8 ON DEVICE: a quarter of the f32 RGBA download (8.3
            # MB/frame at 1080p); 8-bit unorm is the present format —
            # the reference's swapchain is RGBA8. Same conversion
            # utils.image.to_uint8 would apply host-side.
            import jax.numpy as jnp
            return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(
                jnp.uint8)

    import numpy as np

    from .utils.image import AsyncFrameWriter
    collected = [] if args.video else None
    clock = Clock()
    # PNG writes pipeline on a thread pool (the frames-in-flight present
    # analogue) so disk IO overlaps the next frame's render.
    with _MaybeProfile(args.profile_dir), AsyncFrameWriter() as writer:
        for i in range(args.frames):
            t = i / args.fps
            scroll = (reference_media_scroll(t, n_channels=n_ch)
                      if medium.combine == "reference" else None)
            if frame_fn is not None:
                img = jax.block_until_ready(frame_fn(grid, plans[i], scroll))
            else:
                img = jax.block_until_ready(
                    render_image(grid, camera_at(i), cfg, medium, light,
                                 scroll=scroll, backend=args.backend))
            path = os.path.join(args.out_dir, f"frame_{i:05d}.png")
            arr = np.asarray(img)
            writer.write(path, arr)
            if collected is not None:
                collected.append(arr)
            dt = clock.stamp()
            metrics.write(frame=i, seconds=dt, fps=1.0 / max(dt, 1e-9),
                          mrays_per_s=preset.camera.width
                          * preset.camera.height / dt / 1e6)
    if collected is not None:
        from .utils.video import write_video
        vpath = args.video if os.path.isabs(args.video) else os.path.join(
            args.out_dir, args.video)
        write_video(vpath, collected, fps=args.fps)
        log.info("wrote animation to %s", vpath)
    if frame_fn is not None:
        metrics.write(n_compiles=int(frame_fn._cache_size()),
                      n_signatures=n_sigs)
        log.info("animation compiled %d executable(s) for %d frames",
                 frame_fn._cache_size(), args.frames)
    metrics.close()
    log.info("wrote %d frames to %s", args.frames, args.out_dir)
    return 0


def cmd_fit(args):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .config import CameraConfig, LightConfig, MediumConfig, RenderConfig
    from .fit import fit_grid
    from .models.scene import cloud_volume
    from .ops.camera import camera_rays, make_camera
    from .ops.integrate import render_rays
    from .utils.checkpoint import (latest_step, restore_checkpoint,
                                   save_checkpoint)
    from .utils.image import write_png
    from .utils.metrics import MetricsWriter, get_logger

    os.makedirs(args.out_dir, exist_ok=True)
    # Default: the production sweep path end to end (the quadrature
    # the whole architecture exists for); --quadrature fixed keeps the
    # reference-parity gather integrator for cross-checks.
    if args.quadrature == "sliced":
        cfg = RenderConfig(emission=True, quadrature="sliced")
    else:
        cfg = RenderConfig(max_steps=64, step_size=4.0 / 64.0,
                           emission=True)
    med = MediumConfig(combine="single", density=8.0)
    light = LightConfig()
    cam = make_camera(CameraConfig(width=args.image_size,
                                   height=args.image_size))

    true_grid = cloud_volume(args.size, seed=7)
    if args.quadrature == "sliced":
        from .render import render_image
        target = render_image(true_grid, cam, cfg, med, light)[..., :3]
    else:
        o, d = camera_rays(cam)
        target = render_rays(true_grid, o, d, cfg, med, light)[..., :3]
    write_png(os.path.join(args.out_dir, "target.png"), np.asarray(target))

    metrics = MetricsWriter(os.path.join(args.out_dir, "metrics.jsonl"))
    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    init_grid = init_opt = None
    start = 0
    if args.resume and latest_step(ckpt_dir) is not None:
        import optax
        template = optax.adam(args.lr).init(
            jnp.zeros((args.size,) * 3, jnp.float32))
        start, init_grid, init_opt, extra = restore_checkpoint(
            ckpt_dir, opt_state_template=template)
        # A checkpoint written under a different quadrature continues
        # under a different loss/integrator — refuse rather than silently
        # optimize a different objective. Checkpoints from
        # before the metadata was recorded resume with a warning.
        ck_quad = extra.get("quadrature")
        if ck_quad is None:
            get_logger().warning(
                "checkpoint has no quadrature metadata (pre-round-4); "
                "resuming under --quadrature %s", args.quadrature)
        elif ck_quad != args.quadrature:
            raise SystemExit(
                f"checkpoint at {ckpt_dir} was written with quadrature "
                f"{ck_quad!r} but --quadrature is {args.quadrature!r}; "
                "resuming would optimize a different loss. Re-run with "
                f"--quadrature {ck_quad} or a fresh --out-dir.")
        get_logger().info("resuming fit from step %d (%s)", start, ckpt_dir)
    res = fit_grid(
        target, cam, cfg, med, light, grid_size=args.size,
        steps=args.steps, learning_rate=args.lr, metrics=metrics,
        init_grid=init_grid, init_opt_state=init_opt, start_step=start,
        checkpoint_fn=lambda s, g, st: save_checkpoint(
            ckpt_dir, s, g, st, extra={"quadrature": args.quadrature}),
        checkpoint_every=max(args.steps // 4, 1))
    if args.quadrature == "sliced":
        from .render import render_image
        final = render_image(res.grid, cam, cfg, med, light)
    else:
        final = render_rays(res.grid, o, d, cfg, med, light)
    write_png(os.path.join(args.out_dir, "fitted.png"),
              np.asarray(final[..., :3]))
    metrics.close()
    if res.losses:
        get_logger().info("fit: loss %.6f -> %.6f; artifacts in %s",
                          res.losses[0], res.losses[-1], args.out_dir)
    else:
        get_logger().info("fit: already complete at step %d; artifacts "
                          "in %s", res.steps, args.out_dir)
    return 0


def cmd_info(args):
    import jax
    print("devices:", jax.devices())
    print("backend:", jax.default_backend())
    from .config import PRESETS
    for name, p in PRESETS.items():
        print(f"  preset {name}: volume {p.volume.size}^3, "
              f"{p.camera.width}x{p.camera.height}, "
              f"emission={p.render.emission}, "
              f"shadow_steps={p.light.shadow_steps}")
    return 0


def cmd_serve(args):
    import json as _json

    from .config import PRESETS
    from .serve import serve
    from .utils.metrics import get_logger

    preset = PRESETS[args.preset]
    result = serve(preset, port=args.port, frames=args.selftest_frames,
                   host=args.host)
    if result is not None:
        print(_json.dumps(result, indent=1))
        if args.selftest_out:
            with open(args.selftest_out, "w") as f:
                _json.dump(result, f, indent=1)
        get_logger().info("interactive self-test complete")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="volumetricrenderer_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to PNG")
    _add_common(pr)
    pr.add_argument("--time", type=float, default=0.0,
                    help="animation time (drives MediaScroll)")
    pr.add_argument("--out", default="frame.png")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render an animation frame sequence")
    _add_common(pa)
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--fps", type=float, default=24.0)
    pa.add_argument("--orbit", action="store_true",
                    help="orbit camera path (config 4)")
    pa.add_argument("--out-dir", default="frames")
    pa.add_argument("--video", default=None,
                    help="also write the sequence as one animation file: "
                         ".apng (stdlib), .gif (Pillow), or .html "
                         "(self-contained scrubber viewer)")
    pa.set_defaults(fn=cmd_animate)

    pf = sub.add_parser("fit", help="inverse-render fit demo (config 3)")
    pf.add_argument("--size", type=int, default=32)
    pf.add_argument("--image-size", type=int, default=64)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--out-dir", default="fit_run")
    pf.add_argument("--quadrature", default="sliced",
                    choices=["sliced", "fixed"],
                    help="sliced = differentiate through the production "
                         "slice sweep (default); fixed = the reference-"
                         "parity gather integrator")
    pf.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "<out-dir>/ckpt (elastic recovery, SURVEY §5.3)")
    pf.set_defaults(fn=cmd_fit)

    ps = sub.add_parser(
        "serve", help="live interactive renderer over HTTP (the "
                      "TestMain.cpp demo-loop analogue: WASD/QE keys "
                      "drive the camera, R/F the media clock)")
    ps.add_argument("--preset", default="config2")
    ps.add_argument("--port", type=int, default=8788)
    ps.add_argument("--host", default="127.0.0.1",
                    help="bind address; the server has no auth, so "
                         "non-loopback exposure (0.0.0.0) is opt-in")
    ps.add_argument("--selftest-frames", type=int, default=None,
                    help="self-drive mode: issue synthetic key events, "
                         "fetch N frames through the HTTP stack, print "
                         "a JSON fps report, exit")
    ps.add_argument("--selftest-out", default=None,
                    help="write the self-drive JSON report here")
    ps.set_defaults(fn=cmd_serve)

    pi = sub.add_parser("info", help="devices + presets")
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    from .utils.metrics import init_logs
    enable_compile_cache()
    init_logs()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
