#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: rays/sec/card (closest-hit + any-hit queries actually issued) on
a progressive render through the production loop
(render/progressive.render_steps), default the cornell box at 256², 4
bounces (BASELINE config #2 geometry).

vs_baseline: ratio against REFERENCE_RAYS_PER_SEC — the reference app
publishes no numbers (BASELINE.md `published: {}`), so the baseline is an
estimate, not a measurement: a ~2013 mobile GPU rendering 700² at ~30 fps
with 3 closest + up to 3 shadow queries/pixel ≈ 1e8 ray queries/s.

Usage: python bench.py [--width N] [--height N] [--depth N] [--accel auto]
                       [--scene cornell|soup|grid100k|grid1m] [--steps N]

`--accel auto` (the default) is the production accelerator
(ops/traversal.AUTO_ACCEL, the binary BVH), walked by the CUDA kernel on a
GPU.
"""

import argparse
import json
import sys
import time

REFERENCE_RAYS_PER_SEC = 1.0e8  # documented estimate, see module docstring


# displaced_grid resolutions (99,460 and 999,700 triangles).
SCENES = {"grid100k": 224, "grid1m": 708}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument(
        "--accel",
        default="auto",
        choices=["auto", "brute", "bvh2", "sbvh", "cwbvh"],
    )
    ap.add_argument("--scene", default="cornell")
    # Samples per device launch: the production chunking of the reference's
    # 1024-spp progressive workload (Scene.h:49 maxSamples), so per-launch
    # host overhead amortizes.
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)

    from caitlyn.utils import compile_cache

    compile_cache.configure()
    import jax

    from caitlyn.core.types import RenderOptions
    from caitlyn.io import builtin_scenes
    from caitlyn.ops.traversal import AUTO_ACCEL
    from caitlyn.render import sampling
    from caitlyn.render.integrator import trace_paths
    from caitlyn.core.camera import generate_rays
    from caitlyn.scene import required_stack, scene_families, upload_scene

    if args.scene == "cornell":
        scene, _ = builtin_scenes.cornell_box()
    elif args.scene == "soup":
        scene, _ = builtin_scenes.random_triangle_soup(20000)
    elif args.scene in SCENES:
        scene, _ = builtin_scenes.displaced_grid(resolution=SCENES[args.scene])
    else:
        raise SystemExit(f"unknown scene {args.scene}")
    camera = builtin_scenes.builtin_camera(
        "grid" if args.scene.startswith("grid") else args.scene
    )

    if args.accel == "auto":
        args.accel = AUTO_ACCEL

    t_build0 = time.perf_counter()
    ds = upload_scene(scene, accel=args.accel)
    build_s = time.perf_counter() - t_build0

    w, h, depth = args.width, args.height, args.depth
    options = RenderOptions(
        width=w, height=h, max_depth=depth, accel=args.accel,
        families=scene_families(scene), max_stack=required_stack(ds),
    )
    n = w * h

    # Count actual ray queries once (instrumented pass).
    key = jax.random.PRNGKey(0)
    uniforms = sampling.draw_uniforms(key, n, depth)

    @jax.jit
    def count_fn(uniforms):
        o, d = generate_rays(camera, w, h, uniforms)
        _, stats = trace_paths(ds, o, d, uniforms, options, with_stats=True)
        return stats

    stats = jax.device_get(count_fn(uniforms))
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])

    # Timed section = the PRODUCTION progressive loop (render/progressive
    # .py render_steps): `args.steps` samples accumulate inside ONE device
    # launch via lax.scan, exactly what the CLI runs (the per-sample key
    # schedule is bitwise identical to single-sample stepping).
    from caitlyn.render import progressive

    state = progressive.init_state(w, h, seed=0)
    for _ in range(max(args.warmup, 1)):  # compile + warmup launches
        state = progressive.render_steps(ds, camera, state, w, h, options, args.steps)
    jax.block_until_ready(state)
    launches = 2
    t0 = time.perf_counter()
    for _ in range(launches):
        state = progressive.render_steps(ds, camera, state, w, h, options, args.steps)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0

    finite = bool(jax.numpy.isfinite(state.accum).all())
    frames = launches * args.steps
    rays_per_sec = rays_per_sample * frames / elapsed
    ms_per_frame = elapsed / frames * 1e3

    dev = jax.devices()[0]
    result = {
        "metric": "rays/sec/card",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REFERENCE_RAYS_PER_SEC, 4),
        "detail": {
            "scene": args.scene,
            "triangles": int(scene.num_triangles),
            "resolution": [w, h],
            "max_depth": depth,
            "accel": args.accel,
            "ms_per_frame": round(ms_per_frame, 3),
            "rays_per_sample": rays_per_sample,
            "bvh_build_s": round(build_s, 3),
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
            },
            "steps_timed": frames,
            "finite": finite,
            "spp_per_launch": args.steps,
            # wavefront occupancy: live lanes entering each bounce's
            # closest-hit (shows RR / emissive-hit / miss attrition)
            "alive_per_bounce": [int(x) for x in stats["alive_per_bounce"]],
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
