#!/usr/bin/env python
"""BASELINE.md config table runner — one JSON record per benchmark config.

Records rays/sec/card (instrumented closest+anyhit queries), ms/frame and
build time for each of the five BASELINE configs, plus the grad-pass
overhead ratio (config #5's scalar metric) and the cwbvh-vs-bvh2
comparison at 1M triangles (the reference's README.md:22 relative claim).

Writes benchmarks/RESULTS_r{N}.json and prints one JSON line per config.

    python benchmarks/run_configs.py [--round 4] [--skip 4]   # skip big cfgs
"""

import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(ds, camera, scene, options, steps=4, warmup=1):
    import jax
    import jax.numpy as jnp

    from caitlyn.core.camera import generate_rays
    from caitlyn.render import sampling
    from caitlyn.render.integrator import render_sample, trace_paths

    w, h, depth = options.width, options.height, options.max_depth
    n = w * h
    key = jax.random.PRNGKey(0)
    uniforms = sampling.draw_uniforms(key, n, depth)

    # ds/camera must be jit ARGUMENTS, not closures: closed-over device
    # arrays would be baked into the executable as constants.
    @partial(jax.jit, static_argnames=())
    def count_fn(ds, camera, uni):
        o, d = generate_rays(camera, w, h, uni)
        _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
        return stats

    stats = jax.device_get(count_fn(ds, camera, uniforms))
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])

    step = jax.jit(
        lambda ds, camera, acc, uni: acc
        + render_sample(ds, camera, uni, w, h, options)
    )
    unis = [
        sampling.draw_uniforms(jax.random.fold_in(key, i), n, depth)
        for i in range(warmup + steps)
    ]
    acc = jnp.zeros((n, 3), jnp.float32)
    for i in range(warmup):
        acc = step(ds, camera, acc, unis[i])
    acc.block_until_ready()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        acc = step(ds, camera, acc, unis[i])
    acc.block_until_ready()
    dt = time.perf_counter() - t0
    return {
        "rays_per_sec": round(rays_per_sample * steps / dt, 1),
        "ms_per_frame": round(dt / steps * 1e3, 3),
        "rays_per_sample": rays_per_sample,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--round", type=int, default=5)
    ap.add_argument("--skip", type=int, nargs="*", default=[])
    ap.add_argument("--grid1m-res", type=int, default=1024,
                    help="render size for config 4 (1024 = the BASELINE "
                    "spec; pass 512 for a quick run)")
    ap.add_argument("--accel4", nargs="*", default=["cwbvh", "bvh2"],
                    help="accels to measure for config 4")
    args = ap.parse_args()

    import jax

    from caitlyn.core.types import RenderOptions
    from caitlyn.io import builtin_scenes
    from caitlyn.scene import required_stack, scene_families, upload_scene

    results = {"device": str(jax.devices()[0])}

    def record(name, obj):
        results[name] = obj
        print(json.dumps({name: obj}))

    cornell, _ = builtin_scenes.cornell_box()
    ccam = builtin_scenes.builtin_camera("cornell")

    # --- config 1: cornell 64x64, 1 bounce, SAH BVH (CPU-parity config)
    if 1 not in args.skip:
        t0 = time.perf_counter()
        ds = upload_scene(cornell, accel="bvh2")
        build = time.perf_counter() - t0
        opt = RenderOptions(width=64, height=64, max_depth=1, accel="bvh2",
                            families=scene_families(cornell),
                            max_stack=required_stack(ds))
        m = _measure(ds, ccam, cornell, opt, steps=8)
        record("config1_cornell64_bvh2", {**m, "build_s": round(build, 3)})

    # --- config 2: cornell 256x256, 4 bounces (production auto = brute)
    if 2 not in args.skip:
        t0 = time.perf_counter()
        ds = upload_scene(cornell, accel="brute")
        build = time.perf_counter() - t0
        opt = RenderOptions(width=256, height=256, max_depth=4, accel="brute",
                            families=scene_families(cornell))
        m = _measure(ds, ccam, cornell, opt, steps=8)
        record("config2_cornell256_brute", {**m, "build_s": round(build, 3)})

    # --- config 3: SBVH build + traversal, 100k tris, 512x512, 4 bounces.
    # The spatial-split BINARY build feeds the production binary-BVH
    # traversal; the build time recorded is the spatial-split build itself.
    gscene, _ = builtin_scenes.displaced_grid(resolution=224)
    gcam = builtin_scenes.builtin_camera("grid")
    if 3 not in args.skip:
        from caitlyn.accel.sbvh import build_sbvh

        t0 = time.perf_counter()
        sbvh = build_sbvh(gscene.vertices, gscene.tri_v, max_leaf=4)
        sbvh_s = time.perf_counter() - t0
        ds = upload_scene(gscene, accel="sbvh", bvh=sbvh)
        opt = RenderOptions(width=512, height=512, max_depth=4, accel="sbvh",
                            families=scene_families(gscene),
                            max_stack=required_stack(ds))
        m = _measure(ds, gcam, gscene, opt, steps=2)
        record("config3_sbvh100k_512", {**m, "sbvh_build_s": round(sbvh_s, 3)})

    # --- config 4: CWBVH 1M tris vs bvh2 1M tris (README.md:22 claim),
    # at the BASELINE spec (1024^2, 6 bounces) by default, with and
    # without Russian roulette on the bvh2 path (rr_start=2 — the deep-
    # bounce configuration RR exists for).
    if 4 not in args.skip:
        mscene, _ = builtin_scenes.displaced_grid(resolution=708)
        res = args.grid1m_res
        for accel in args.accel4:
            t0 = time.perf_counter()
            ds = upload_scene(mscene, accel=accel)
            build = time.perf_counter() - t0
            opt = RenderOptions(width=res, height=res, max_depth=6,
                                accel=accel, families=scene_families(mscene),
                                max_stack=required_stack(ds))
            m = _measure(ds, gcam, mscene, opt, steps=1, warmup=1)
            record(f"config4_grid1m_{accel}_{res}",
                   {**m, "build_s": round(build, 3)})
            if accel == "bvh2":
                m_rr = _measure(ds, gcam, mscene,
                                opt._replace(rr_start=2), steps=1, warmup=1)
                record(f"config4_grid1m_bvh2_{res}_rr2", m_rr)

    # --- config 5 scalar: grad-pass overhead ratio (cornell 64, depth 2)
    if 5 not in args.skip:
        import jax.numpy as jnp

        from caitlyn.grad.inverse import make_loss
        from caitlyn.render import sampling
        from caitlyn.render.integrator import render_sample

        ds = upload_scene(cornell, accel="bvh2")
        w = h = 64
        opt = RenderOptions(width=w, height=h, max_depth=2, accel="bvh2",
                            families=scene_families(cornell))
        key = jax.random.PRNGKey(0)
        uni = sampling.draw_uniforms(key, w * h, 2)
        fwd = jax.jit(lambda u: render_sample(ds, ccam, u, w, h, opt))
        fwd(uni).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(8):
            out = fwd(uni)
        out.block_until_ready()
        t_fwd = (time.perf_counter() - t0) / 8

        target = fwd(uni)
        loss_fn = make_loss(ds, ccam, target, w, h, opt)
        params = {"albedo": ds.scene.materials.albedo,
                  "disney": ds.scene.materials.disney,
                  "cam_position": jnp.asarray(ccam.position)}
        gf = jax.jit(jax.value_and_grad(loss_fn))
        gf(params, key)[0].block_until_ready()
        t0 = time.perf_counter()
        for _ in range(8):
            loss, grads = gf(params, key)
        loss.block_until_ready()
        t_grad = (time.perf_counter() - t0) / 8
        record("config5_grad_overhead", {
            "forward_ms": round(t_fwd * 1e3, 3),
            "value_and_grad_ms": round(t_grad * 1e3, 3),
            "overhead_ratio": round(t_grad / t_fwd, 3),
        })

        # Production-path grad overhead (the number BASELINE actually
        # wants): value_and_grad vs forward on the production accel at
        # 256^2 on the 100k-tri scene — the backward re-plays shading
        # from the traversal's detached hit ids.
        ds_w = upload_scene(gscene, accel="bvh2")
        w = h = 256
        opt_w = RenderOptions(width=w, height=h, max_depth=2, accel="bvh2",
                              families=scene_families(gscene),
                              max_stack=required_stack(ds_w))
        uni = sampling.draw_uniforms(key, w * h, 2)
        fwd_w = jax.jit(
            lambda ds_, u: render_sample(ds_, gcam, u, w, h, opt_w)
        )
        fwd_w(ds_w, uni).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(4):
            out = fwd_w(ds_w, uni)
        out.block_until_ready()
        t_fwd_w = (time.perf_counter() - t0) / 4

        target_w = fwd_w(ds_w, uni)
        loss_w = make_loss(ds_w, gcam, target_w, w, h, opt_w)
        params_w = {"albedo": ds_w.scene.materials.albedo,
                    "disney": ds_w.scene.materials.disney,
                    "cam_position": jnp.asarray(gcam.position)}
        gfw = jax.jit(jax.value_and_grad(loss_w))
        gfw(params_w, key)[0].block_until_ready()
        t0 = time.perf_counter()
        for _ in range(4):
            loss, grads = gfw(params_w, key)
        loss.block_until_ready()
        t_grad_w = (time.perf_counter() - t0) / 4
        record("config5_grad_overhead_bvh2_256", {
            "forward_ms": round(t_fwd_w * 1e3, 3),
            "value_and_grad_ms": round(t_grad_w * 1e3, 3),
            "overhead_ratio": round(t_grad_w / t_fwd_w, 3),
        })

    out_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        f"RESULTS_r{args.round}.json",
    )
    # Merge with an existing round file so --skip'd configs measured in a
    # separate invocation (the big ones outrun one driver window) survive.
    merged = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            merged = json.load(f)
    merged.update(results)
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=2)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
