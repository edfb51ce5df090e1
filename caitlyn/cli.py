"""Command-line interface: render / benchmark / optimize.

The framework-surface replacement for the reference's GLFW/imgui app
(`/root/reference/Caitlyn/main.cpp`): offline progressive rendering with
checkpoint/resume and PNG output, the benchmark harness, and the
inverse-rendering optimizer.

    python -m caitlyn.cli render scene.toml -o out.png --spp 64
    python -m caitlyn.cli render scene.toml --resume ckpt.npz
    python -m caitlyn.cli optimize scene.toml --target ref.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def cmd_render(args) -> int:
    if args.mesh:
        # Multi-host wiring MUST precede any backend query (jax.devices,
        # jit, device_put) — see parallel.distributed.init_distributed.
        from caitlyn.parallel.distributed import init_distributed

        init_distributed()
    import jax
    import numpy as np

    from caitlyn.render import progressive
    from caitlyn.render.tiled import render_image_tiled
    from caitlyn.scene import required_stack, upload_scene
    from caitlyn.io.image import save_png
    from caitlyn.utils import checkpoint, config, metrics

    cfg = config.load_config(args.config)
    scene, translation = config.scene_from_config(cfg, os.path.dirname(args.config))
    camera = config.camera_from_config(cfg, translation)
    options = config.options_from_config(
        cfg,
        width=args.width,
        height=args.height,
        max_depth=args.depth,
        accel=args.accel,
        aov=args.aov,
    )

    if options.accel == "auto":
        from caitlyn.ops.traversal import AUTO_ACCEL

        options = options._replace(accel=AUTO_ACCEL)
    if "families" not in cfg.get("render", {}):
        from caitlyn.scene import scene_families

        # Trace only the shading lobes the scene's materials use (static
        # jit specialization; an all-Lambert scene skips Disney/glass).
        options = options._replace(families=scene_families(scene))
    t0 = time.perf_counter()
    ds = upload_scene(scene, accel=options.accel, max_leaf=options.max_leaf)
    # Size the traversal stack from the actual build — deep trees would
    # silently overflow a fixed stack (see scene.required_stack).
    options = options._replace(max_stack=required_stack(ds))
    metrics.log_record(
        "scene",
        {
            "triangles": scene.num_triangles,
            "lights": scene.lights.count,
            "materials": scene.materials.count,
            "accel": options.accel,
            "build_s": round(time.perf_counter() - t0, 3),
        },
    )

    spp = args.spp or options.max_samples
    spl = max(1, args.spp_per_launch)  # guard non-positive values

    if args.mesh:
        # Sharded render over the device mesh: pixels over dp, sample
        # streams over sp (psum), image assembled on every host.  The
        # same path runs on the 8-device virtual CPU mesh, one card, or
        # several hosts (jax.distributed wiring above).
        from caitlyn.parallel.distributed import (
            assemble_image,
            make_multihost_mesh,
        )
        from caitlyn.parallel.render import (
            init_sharded_state,
            sharded_render_step,
        )

        sp = None
        if args.mesh != "auto":
            dp_s, _, sp_s = args.mesh.lower().partition("x")
            sp = int(sp_s) if sp_s else 1
            n_dev = len(jax.devices())
            if int(dp_s) * sp != n_dev:
                raise SystemExit(
                    f"--mesh {args.mesh} needs {int(dp_s) * sp} devices, "
                    f"found {n_dev}"
                )
        mesh = make_multihost_mesh(sp)
        sp = mesh.shape["sp"]
        w, h = options.width, options.height
        state = init_sharded_state(mesh, w, h, seed=args.seed)
        timer = metrics.StepTimer()
        steps = max(1, spp // sp)
        for _ in range(steps):
            with timer.span("step"):
                state = sharded_render_step(
                    ds, camera, state, mesh, w, h, options
                )
                state.accum.block_until_ready()
            timer.count("samples", sp)
        img = assemble_image(state, mesh, w, h, options, sp)
        if jax.process_index() == 0:
            save_png(args.output, np.asarray(img))
            metrics.log_record(
                "mesh_render",
                {"mesh": dict(mesh.shape), "spp": steps * sp, **timer.summary()},
            )
            print(f"wrote {args.output} ({steps * sp} spp, mesh {dict(mesh.shape)})")
        return 0

    if args.turntable > 1:
        # Camera-path mode: the offline analog of the reference's
        # interactive loop (`main.cpp:97-153` — camera motion sets
        # isMoving, `Scene.h:1160-1177` clears the accumulation).  The
        # camera orbits the look-at point; every move RESETS the shared
        # progressive state and re-accumulates spp samples.
        from caitlyn.core.types import make_camera

        pos0 = np.asarray(camera.position, np.float32)
        look = pos0 + np.asarray(camera.forward, np.float32)
        fov = float(np.rad2deg(camera.fov))
        w, h = options.width, options.height
        state = progressive.init_state(w, h, seed=args.seed)
        base, ext = os.path.splitext(args.output)
        rel = pos0 - look
        for k in range(args.turntable):
            ang = 2.0 * np.pi * k / args.turntable
            ca, sa = np.cos(ang), np.sin(ang)
            rot = np.array(
                [rel[0] * ca + rel[2] * sa, rel[1], -rel[0] * sa + rel[2] * ca],
                np.float32,
            )
            cam_k = make_camera(look + rot, look, fov_degrees=fov)
            state = progressive.reset(state)  # camera moved → restart
            # Chunk by --spp-per-launch like the main loop: one multi-
            # minute launch of all spp samples would outrun the driver/
            # measurement window on big scenes.
            while int(state.frame_count) < spp:
                chunk = min(spl, spp - int(state.frame_count))
                state = progressive.render_steps(
                    ds, cam_k, state, w, h, options, chunk
                )
            img = progressive.resolve(state, w, h, options)
            frame_path = f"{base}_{k:03d}{ext}"
            save_png(frame_path, np.asarray(img))
            print(f"wrote {frame_path} ({spp} spp, frame {k + 1}/{args.turntable})")
        return 0

    if options.num_tiles_x * options.num_tiles_y > 1:
        img = render_image_tiled(ds, camera, options, spp=spp, seed=args.seed)
        save_png(args.output, img)
        print(f"wrote {args.output} ({spp} spp, tiled)")
        return 0

    w, h = options.width, options.height
    if args.resume and os.path.exists(args.resume):
        state = checkpoint.load_render_state(args.resume)
        print(f"resumed at {int(state.frame_count)} spp")
    else:
        state = progressive.init_state(w, h, seed=args.seed)

    # Instrumented ray count per sample (same metric as bench.py): the
    # integrator counts the closest-hit and any-hit queries it actually
    # issues, instead of the optimistic w*h*depth*2 upper bound.
    from caitlyn.core.camera import generate_rays
    from caitlyn.render import sampling
    from caitlyn.render.integrator import trace_paths

    @jax.jit
    def _count(uni):
        o, d = generate_rays(camera, w, h, uni)
        _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
        return stats

    _stats = jax.device_get(_count(sampling.draw_uniforms(
        jax.random.PRNGKey(args.seed), w * h, options.max_depth)))
    rays_per_sample = int(_stats["rays_closest"]) + int(_stats["rays_anyhit"])

    if args.debug_checks:
        # Fail fast on numerics: one checkified sample raises a located
        # error if any radiance value is NaN/inf (utils/debug.py), BEFORE
        # hours of accumulation get silently poisoned.
        from caitlyn.utils.debug import checked_render_sample

        checked_render_sample(
            ds, camera,
            sampling.draw_uniforms(jax.random.PRNGKey(args.seed), w * h,
                                   options.max_depth),
            w, h, options,
        )
        metrics.log_record("debug_checks", {"finite": True})

    timer = metrics.StepTimer()
    last_ckpt = time.time()
    last_logged = 0
    log_every = max(spp // 10, 1)
    while int(state.frame_count) < spp:
        # Batch samples per device launch (lax.scan in render_steps) so
        # the host dispatches once per chunk.  The tail runs single steps
        # to avoid a second compile.
        # When checkpointing, cap the chunk so one launch stays under
        # ~checkpoint_every of expected wall time (preemption can only
        # lose work between launches).
        todo = spp - int(state.frame_count)
        chunk = spl if todo >= spl else 1
        if args.resume and chunk > 1 and timer.counts.get("samples", 0) > 0:
            s_per_sample = timer.spans.get("step", 0.0) / timer.counts["samples"]
            budget = max(1, int(args.checkpoint_every / max(s_per_sample, 1e-9)))
            # round the cap down to a power of two so `render_steps`
            # compiles for at most a couple of distinct chunk lengths
            while chunk > budget and chunk > 1:
                chunk //= 2
        with timer.span("step"):
            if chunk > 1:
                state = progressive.render_steps(
                    ds, camera, state, w, h, options, chunk
                )
            else:
                state = progressive.render_step(ds, camera, state, w, h, options)
            state.accum.block_until_ready()
        timer.count("samples", chunk)
        timer.count("rays", rays_per_sample * chunk)
        if args.resume and time.time() - last_ckpt > args.checkpoint_every:
            checkpoint.save_render_state(args.resume, state)
            last_ckpt = time.time()
        # Log whenever frame_count crosses the next spp/10 boundary (the
        # counter advances in chunk-sized jumps, so `% boundary` would
        # mostly never fire).
        if int(state.frame_count) // log_every > last_logged // log_every:
            last_logged = int(state.frame_count)
            metrics.log_record(
                "progress",
                {"spp": int(state.frame_count), **timer.summary()},
            )

    if args.resume:
        checkpoint.save_render_state(args.resume, state)
    img = progressive.resolve(state, w, h, options)
    save_png(args.output, np.asarray(img))
    print(f"wrote {args.output} ({int(state.frame_count)} spp)")
    return 0


def cmd_benchmark(args) -> int:
    # Delegate to the repo-root harness (single JSON line contract).  The
    # child is the only process that opens the device: this one imports
    # nothing of JAX.
    import subprocess

    cmd = [sys.executable, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")]
    cmd += args.bench_args
    return subprocess.call(cmd)


def cmd_optimize(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caitlyn.grad.inverse import optimize
    from caitlyn.render import progressive, sampling
    from caitlyn.render.integrator import render_sample
    from caitlyn.scene import required_stack, upload_scene
    from caitlyn.utils import checkpoint, config, metrics

    cfg = config.load_config(args.config)
    scene, translation = config.scene_from_config(cfg, os.path.dirname(args.config))
    camera = config.camera_from_config(cfg, translation)
    options = config.options_from_config(
        cfg, width=args.width, height=args.height, max_depth=args.depth
    )
    if options.accel == "auto":
        from caitlyn.ops.traversal import AUTO_ACCEL

        options = options._replace(accel=AUTO_ACCEL)
    if "families" not in cfg.get("render", {}):
        from caitlyn.scene import scene_families

        options = options._replace(families=scene_families(scene))
    ds = upload_scene(scene, accel=options.accel, max_leaf=options.max_leaf)
    options = options._replace(max_stack=required_stack(ds))
    w, h = options.width, options.height

    if args.target:
        from caitlyn.io.image import load_png

        # Treat the PNG as a tonemapped display image — invert gamma to a
        # rough radiance target (exact HDR targets come from .npz).
        img = load_png(args.target) ** 2.2
        target = jnp.asarray(img[::-1].reshape(-1, 3))
    else:
        # Self-target demo: render the ground truth, perturb, recover.
        key = jax.random.PRNGKey(0)
        target = jnp.zeros((w * h, 3))
        for i in range(args.target_spp):
            uni = sampling.draw_uniforms(jax.random.fold_in(key, i), w * h, options.max_depth)
            target = target + render_sample(ds, camera, uni, w, h, options)
        target = target / args.target_spp

    # Optimize only the parameter groups that are actually perturbed —
    # including identity-perturbed groups just adds MC-noise random walk
    # (Adam steps ~lr per step regardless of gradient signal).
    params = {}
    truth = {}
    if args.perturb != 1.0:
        params["albedo"] = ds.scene.materials.albedo.at[:, :3].mul(args.perturb)
        truth["albedo"] = ds.scene.materials.albedo
    if args.perturb_roughness:
        # Disney parameter recovery (BASELINE config #5): offset the
        # roughness of the DISNEY-typed materials (only those rows have
        # gradient signal) and let the optimizer pull it back.
        from caitlyn.core.types import LAMBERT_TYPES

        types = ds.scene.materials.albedo[:, 3].astype(jnp.int32)
        lam = jnp.isin(types, jnp.asarray([int(t) for t in LAMBERT_TYPES]))
        opt_rows = ~lam  # the disney-family rows
        true_d = ds.scene.materials.disney
        r0 = jnp.clip(
            true_d[:, 0] + args.perturb_roughness, 0.02, 0.98
        )
        params["disney"] = true_d.at[:, 0].set(
            jnp.where(opt_rows, r0, true_d[:, 0])
        )
        truth["disney"] = true_d
        truth["_disney_rows"] = opt_rows
    if args.optimize_camera:
        params["cam_position"] = jnp.asarray(camera.position)
        truth["cam_position"] = jnp.asarray(camera.position)

    def cb(i, loss, p):
        if i % 10 == 0:
            metrics.log_record("opt", {"step": i, "loss": round(loss, 6)})

    params, losses = optimize(
        ds, camera, target, params, w, h, options,
        steps=args.steps, lr=args.lr, seed=args.seed, callback=cb,
    )
    checkpoint.save_params(args.output, params)
    metrics.log_record("opt_losses", {"losses": [float(x) for x in losses]})
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; wrote {args.output}")
    if not args.target:
        # Self-target mode knows the ground truth: report recovery error
        # per parameter group (the convergence metric, not just motion).
        for k, tv in truth.items():
            if k not in params:
                continue
            err_m = jnp.abs(params[k] - tv)
            if k == "disney" and "_disney_rows" in truth:
                # only the disney-typed rows' roughness carries signal
                err_m = jnp.where(truth["_disney_rows"], err_m[:, 0], 0.0)
            err = float(jnp.max(err_m))
            metrics.log_record("opt_final", {"param": k, "max_err": round(err, 5)})
            print(f"  {k}: max |err| vs truth = {err:.5f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="caitlyn")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render to PNG")
    r.add_argument("config")
    r.add_argument("-o", "--output", default="render.png")
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--accel", default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--resume", default=None, help="checkpoint path (save/load)")
    r.add_argument("--checkpoint-every", type=float, default=60.0)
    r.add_argument(
        "--spp-per-launch", type=int, default=64,
        help="samples accumulated per device launch (lax.scan batching; "
        "amortizes host dispatch latency).  With --resume the chunk "
        "is additionally capped so one launch stays under roughly "
        "--checkpoint-every of wall time (checkpoints happen between "
        "launches).  Values < 1 are treated as 1.",
    )
    r.add_argument(
        "--mesh", default=None, metavar="DPxSP|auto",
        help="render sharded over the device mesh (pixels over dp, sample "
        "streams over sp), e.g. --mesh 4x2 or --mesh auto; wires "
        "jax.distributed on multi-host launchers",
    )
    r.add_argument(
        "--aov",
        default=None,
        choices=["beauty", "albedo", "normal", "depth"],
        help="debug render mode (first-hit AOV instead of the beauty pass)",
    )
    r.add_argument(
        "--debug-checks", action="store_true",
        help="checkify one sample for NaN/inf radiance before rendering "
        "(numerical sanitizer; see utils/debug.py)",
    )
    r.add_argument(
        "--turntable",
        type=int,
        default=1,
        help="render N frames orbiting the look-at point (exercises the "
        "camera-move accumulation restart); writes OUTPUT_000.png ...",
    )
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", help="run the benchmark harness")
    b.add_argument("bench_args", nargs=argparse.REMAINDER)
    b.set_defaults(fn=cmd_benchmark)

    o = sub.add_parser("optimize", help="inverse rendering")
    o.add_argument("config")
    o.add_argument("-o", "--output", default="params.npz")
    o.add_argument("--target", default=None, help="target PNG (else self-target demo)")
    o.add_argument("--target-spp", type=int, default=8)
    o.add_argument("--steps", type=int, default=100)
    o.add_argument("--lr", type=float, default=2e-2)
    o.add_argument("--perturb", type=float, default=0.5)
    o.add_argument(
        "--perturb-roughness", type=float, default=0.0,
        help="offset Disney roughness by this much and recover it "
        "(self-target mode)",
    )
    o.add_argument("--optimize-camera", action="store_true")
    o.add_argument("--width", type=int, default=64)
    o.add_argument("--height", type=int, default=64)
    o.add_argument("--depth", type=int, default=None)
    o.add_argument("--seed", type=int, default=0)
    o.set_defaults(fn=cmd_optimize)

    args = ap.parse_args(argv)
    if args.fn is not cmd_benchmark:
        from caitlyn.utils import compile_cache

        compile_cache.configure()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
