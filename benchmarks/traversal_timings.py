#!/usr/bin/env python
"""Ray-query and frame timings per traversal implementation, on the card.

For each scene it times, on one bounce's worth of rays (a width² frame's
primary rays plus as many bounce-like rays, utils/parity.parity_rays):
closest hit and any hit for every implementation ops/traversal.py can
select (CUDA kernel on bvh2/sbvh, XLA on bvh2/sbvh, XLA CWBVH, the dense
sweep where it fits), then render_steps ms/frame through the production
loop with each implementation.  The XLA implementations are reached on the
GPU by patching ops/traversal.select, which only this script does.  It
also times the shading-table row gather at cornell 700² as a plain gather
and as the one-hot matmul formulation the renderer used to have.

    python benchmarks/traversal_timings.py [--scenes cornell grid100k ...]

Prints one JSON line per measurement, each with the card's name and power
limit (nvidia-smi).  Times are medians of --reps runs after a warm-up, in
milliseconds, ending in block_until_ready.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# scene → (frame width for the query rays, render cell (w, depth))
CELLS = {
    "cornell": (700, (700, 3)),
    "soup2k": (512, (512, 3)),
    "grid100k": (512, (512, 4)),
    "grid1m": (512, (1024, 6)),
}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _time(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    out.sort()
    return round(out[len(out) // 2], 3)


def _scene(name):
    from caitlyn.io import builtin_scenes as bs

    if name == "cornell":
        return bs.cornell_box()[0], bs.builtin_camera("cornell")
    if name == "soup2k":
        return bs.random_triangle_soup(2000, seed=1)[0], bs.builtin_camera("soup")
    res = {"grid100k": 224, "grid1m": 708}[name]
    return bs.displaced_grid(resolution=res)[0], bs.builtin_camera("grid")


def queries(name, reps, emit):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caitlyn.ops import intersect as isect
    from caitlyn.ops import traverse_cuda
    from caitlyn.ops.traverse_cwbvh import cwbvh_anyhit, cwbvh_closest
    from caitlyn.ops.traverse_xla import traverse_anyhit, traverse_closest
    from caitlyn.scene import required_stack, upload_scene
    from caitlyn.utils.parity import parity_rays

    scene, cam = _scene(name)
    width = CELLS[name][0]
    ds = upload_scene(scene, accel="bvh2")
    o, d = parity_rays(ds.scene.vertices, ds.scene.tri_v, cam, width, width,
                       lambda o, d: traverse_cuda.closest(
                           o, d, jnp.ones(o.shape[0], bool), ds.bvh_nodes,
                           ds.scene.vertices, ds.scene.tri_v, required_stack(ds)),
                       seed=1)
    o, d = jnp.asarray(o), jnp.asarray(d)
    n = o.shape[0]
    act = jnp.ones(n, bool)
    # the SBVH host build takes minutes at a million triangles
    accels = ["bvh2", "sbvh", "cwbvh"] if scene.num_triangles <= 200_000 else ["bvh2", "cwbvh"]
    if scene.num_triangles <= 20000:
        accels.append("brute")
    t_max = None
    for accel in accels:
        t0 = time.perf_counter()
        ds = upload_scene(scene, accel=accel)
        build = round(time.perf_counter() - t0, 3)
        sc, stack = ds.scene, required_stack(ds)
        impls = {}
        if accel in ("bvh2", "sbvh"):
            impls["cuda"] = (
                jax.jit(lambda o, d: traverse_cuda.closest(
                    o, d, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)),
                jax.jit(lambda o, d, tm: traverse_cuda.anyhit(
                    o, d, tm, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)),
            )
            impls["xla"] = (
                jax.jit(lambda o, d: traverse_closest(
                    o, d, act, ds.node_bounds, ds.node_meta, sc.vertices,
                    sc.tri_v, max_stack=stack)),
                jax.jit(lambda o, d, tm: traverse_anyhit(
                    o, d, tm, act, ds.node_bounds, ds.node_meta, sc.vertices,
                    sc.tri_v, max_stack=stack)),
            )
        elif accel == "cwbvh":
            impls["xla"] = (
                jax.jit(lambda o, d: cwbvh_closest(o, d, act, ds.cw_nodes, ds.cw_tris)),
                jax.jit(lambda o, d, tm: cwbvh_anyhit(o, d, tm, act, ds.cw_nodes, ds.cw_tris)),
            )
        else:
            impls["dense"] = (
                jax.jit(lambda o, d: isect.intersect_brute(o, d, sc.vertices, sc.tri_v)),
                jax.jit(lambda o, d, tm: isect.occluded_brute(o, d, tm, sc.vertices, sc.tri_v)),
            )
        for impl, (closest, anyhit) in impls.items():
            if t_max is None:
                t, tri = closest(o, d)[:2]
                scale = np.random.default_rng(2).uniform(0.5, 1.5, n).astype(np.float32)
                t_max = jnp.where(tri >= 0, t * jnp.asarray(scale), 100.0)
            emit({
                "what": "query", "scene": name, "triangles": scene.num_triangles,
                "rays": n, "accel": accel, "impl": impl, "build_s": build,
                "closest_ms": _time(lambda: closest(o, d), reps),
                "anyhit_ms": _time(lambda: anyhit(o, d, t_max), reps),
            })


def frames(name, reps, emit):
    import jax

    from caitlyn.core.types import RenderOptions
    from caitlyn.ops import traversal
    from caitlyn.render import progressive
    from caitlyn.scene import required_stack, scene_families, upload_scene

    scene, cam = _scene(name)
    w, depth = CELLS[name][1]
    runs = [("bvh2", "cuda_bvh"), ("bvh2", "xla_bvh"), ("cwbvh", "xla_cwbvh")]
    if scene.num_triangles <= 20000:
        runs.append(("brute", "dense"))
    spp = 2
    for accel, impl in runs:
        ds = upload_scene(scene, accel=accel)
        opts = RenderOptions(width=w, height=w, max_depth=depth, accel=accel,
                             families=scene_families(scene),
                             max_stack=required_stack(ds))
        jax.clear_caches()
        with mock.patch.object(traversal, "select", lambda *a, _i=impl: _i):
            state = progressive.init_state(w, w)

            def run():
                nonlocal state
                state = progressive.render_steps(ds, cam, state, w, w, opts, spp)
                return state.accum

            ms = _time(run, reps) / spp
        emit({"what": "frame", "scene": name, "resolution": [w, w],
              "depth": depth, "accel": accel, "impl": impl,
              "ms_per_frame": round(ms, 3)})


def gathers(reps, emit):
    """Shading-table row gather at cornell 700²: plain vs one-hot matmul."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from caitlyn.io.builtin_scenes import cornell_box
    from caitlyn.render.integrator import _build_shade_table
    from caitlyn.scene import upload_scene

    ds = upload_scene(cornell_box()[0], accel="brute")
    tab = _build_shade_table(ds.scene)
    idx = jnp.asarray(np.random.default_rng(0).integers(0, tab.shape[0], 700 * 700),
                      jnp.int32)

    def onehot(table, i):
        oh = (i[:, None] == jnp.arange(table.shape[0], dtype=jnp.int32)[None, :])
        return jnp.dot(oh.astype(table.dtype), table, precision=jax.lax.Precision.HIGHEST)

    plain = jax.jit(lambda t, i: t[i])
    mm = jax.jit(onehot)
    same = bool(jnp.array_equal(plain(tab, idx), mm(tab, idx)))
    emit({"what": "gather", "table": list(tab.shape), "rows": int(idx.shape[0]),
          "plain_ms": _time(lambda: plain(tab, idx), reps),
          "onehot_ms": _time(lambda: mm(tab, idx), reps), "bitwise_equal": same})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", nargs="*", default=list(CELLS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from caitlyn.utils import compile_cache

    compile_cache.configure()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: {jax.devices()}")
    card = _card()

    def emit(rec):
        print(json.dumps({**rec, "device": dev.device_kind, "card": card}), flush=True)

    gathers(args.reps, emit)
    for name in args.scenes:
        queries(name, args.reps, emit)
        frames(name, max(1, args.reps // 2), emit)


if __name__ == "__main__":
    main()
