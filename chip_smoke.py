#!/usr/bin/env python
"""Smoke test of the renderer on an NVIDIA GPU, through its entry points.

    python chip_smoke.py               # one card: kernels, parity, main path
    python chip_smoke.py --devices 4   # four cards: the sharded path only

One card, in one process that holds the card:
  * build and load the CUDA BVH traversal (native/traverse.cu);
  * parity at real widths: the kernel's closest hit against the XLA
    traversal and the dense sweep, its any hit against the XLA traversal,
    at cornell, a 20k-triangle soup, grid100k and a ray subset of grid1m
    (tolerances in caitlyn/utils/parity.py);
  * the cornell golden (64², 48 spp) rendered on the card with bvh2 (what
    auto selects) and with the dense sweep, against
    scenes/golden/cornell_64_cpu.npz;
  * interactive preview at the reference's settings: `cli render
    scenes/cornell.toml` at 700², 3 bounces, a few chunks of samples;
  * an offline frame at a million triangles: `bench.py --scene grid1m` at
    1024², 6 bounces, a few samples through `auto`;
  * inverse rendering: `cli optimize scenes/cornell_disney.toml` at 256²
    for a handful of Adam steps; the loss must be finite and fall.
With --devices 4 it runs only the sharded render on (4,1) and (2,2) meshes
against the one-card render (bitwise), one sharded train step, and
`cli render --mesh auto`.

It exits non-zero, without the final line, when JAX finds no GPU, when the
kernel library cannot be built, or when any phase fails.  The last line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    """nvidia-smi's name and power limit of every card (stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


class _Records(logging.Handler):
    """Collects caitlyn's structured log records (utils/metrics.log_record)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        kind, _, body = record.getMessage().partition(" ")
        try:
            self.records.append((kind, json.loads(body)))
        except json.JSONDecodeError:
            pass

    def of(self, kind):
        return [r for k, r in self.records if k == kind]


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.tmp = tempfile.mkdtemp(prefix="caitlyn_smoke_")
        self.log = _Records()
        lg = logging.getLogger("caitlyn")
        lg.setLevel(logging.INFO)
        lg.addHandler(self.log)

    def report(self, phase, **fields):
        print(json.dumps({"phase": phase, **fields, "card": self.card}), flush=True)

    # -- one card -----------------------------------------------------------

    def kernel_build(self):
        from caitlyn.ops import traverse_cuda

        t0 = time.perf_counter()
        path = traverse_cuda.load()
        self.report("kernel_build", library=os.path.relpath(path, REPO),
                    seconds=round(time.perf_counter() - t0, 3))

    def parity(self, name, scene, camera, width, brute_rays):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from caitlyn.io.builtin_scenes import builtin_camera
        from caitlyn.ops import intersect as isect
        from caitlyn.ops import traverse_cuda
        from caitlyn.ops.traverse_xla import traverse_anyhit, traverse_closest
        from caitlyn.scene import required_stack, upload_scene
        from caitlyn.utils import parity

        t0 = time.perf_counter()
        ds = upload_scene(scene, accel="bvh2")
        build_s = time.perf_counter() - t0
        stack = required_stack(ds)
        sc = ds.scene
        cam = builtin_camera(camera)

        def ref_closest(o, d):
            return traverse_closest(o, d, jnp.ones(o.shape[0], bool), ds.node_bounds,
                                    ds.node_meta, sc.vertices, sc.tri_v, max_stack=stack)

        o, d = parity.parity_rays(sc.vertices, sc.tri_v, cam, width, width,
                                  ref_closest, seed=1)
        o, d = jnp.asarray(o), jnp.asarray(d)
        n = o.shape[0]
        act = jnp.ones(n, bool)
        got = traverse_cuda.closest(o, d, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)
        ref = ref_closest(o, d)
        vs_xla = parity.compare_closest(ref, got, o, d, sc.vertices, sc.tri_v)

        # The dense sweep materialises (rays, triangles) temporaries, so it
        # sees a random ray subset in chunks small enough for device memory.
        m = min(brute_rays, n)
        chunk = max(1, min(m, (1 << 28) // max(scene.num_triangles, 1)))
        m -= m % chunk
        rng = np.random.default_rng(2)
        sub = jnp.asarray(np.sort(rng.choice(n, m, replace=False)))
        ob, db = o[sub], d[sub]
        ref_b = jax.lax.map(
            lambda r: isect.intersect_brute(r[0], r[1], sc.vertices, sc.tri_v),
            (ob.reshape(-1, chunk, 3), db.reshape(-1, chunk, 3)),
        )
        ref_b = tuple(x.reshape(m) for x in ref_b)
        got_b = tuple(x[sub] for x in got)
        vs_brute = parity.compare_closest(ref_b, got_b, ob, db, sc.vertices, sc.tri_v)

        scale = jnp.asarray(rng.uniform(0.5, 1.5, n).astype(np.float32))
        t_max = jnp.where(got[1] >= 0, got[0] * scale, 100.0)
        occ = traverse_cuda.anyhit(o, d, t_max, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)
        occ_ref = traverse_anyhit(o, d, t_max, act, ds.node_bounds, ds.node_meta,
                                  sc.vertices, sc.tri_v, max_stack=stack)
        any_vs_xla = parity.compare_anyhit(occ_ref, occ)
        self.report(f"parity_{name}", triangles=scene.num_triangles,
                    bvh_build_s=round(build_s, 3), closest_vs_xla=vs_xla,
                    closest_vs_dense=vs_brute, anyhit_vs_xla=any_vs_xla)
        bad = [k for k, r, ok in (("closest_vs_xla", vs_xla, parity.closest_ok),
                                  ("closest_vs_dense", vs_brute, parity.closest_ok),
                                  ("anyhit_vs_xla", any_vs_xla, parity.anyhit_ok))
               if not ok(r)]
        if bad:
            raise AssertionError(f"parity_{name}: {bad} outside tolerance")

    def golden(self):
        import numpy as np

        from caitlyn.core.types import RenderOptions
        from caitlyn.io.builtin_scenes import builtin_camera, cornell_box
        from caitlyn.render import progressive
        from caitlyn.scene import required_stack, scene_families, upload_scene

        gold = np.load(os.path.join(REPO, "scenes", "golden", "cornell_64_cpu.npz"))["img"]
        scene, _ = cornell_box()
        # the production accelerator (auto) and the dense sweep
        for accel in ("bvh2", "brute"):
            ds = upload_scene(scene, accel=accel)
            opts = RenderOptions(width=64, height=64, max_depth=3, accel=accel,
                                 families=scene_families(scene),
                                 max_stack=required_stack(ds))
            img, _ = progressive.render_image(ds, builtin_camera("cornell"), opts,
                                              spp=48, seed=0)
            err = np.abs(np.asarray(img) - gold)
            self.report("golden", accel=accel, mean_abs=float(err.mean()),
                        max_abs=float(err.max()))
            if not (err.mean() < 2e-3 and err.max() < 0.06):
                raise AssertionError(f"golden ({accel}) outside mean<2e-3, max<0.06")

    def preview(self):
        from caitlyn import cli
        from caitlyn.io.image import load_png

        out = os.path.join(self.tmp, "preview.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", os.path.join(REPO, "scenes", "cornell.toml"),
                       "--width", "700", "--height", "700", "--depth", "3",
                       "--spp", "16", "--spp-per-launch", "4", "-o", out])
        wall = time.perf_counter() - t0
        img = load_png(out)
        prog = self.log.of("progress")
        scene = self.log.of("scene")[-1]
        # the first chunk includes compilation; the last one is steady
        last = (prog[-1]["step"] - prog[-2]["step"]) / (prog[-1]["spp"] - prog[-2]["spp"])
        self.report("cli_render_preview", rc=rc, accel=scene["accel"],
                    image=list(img.shape), mean=float(img.mean()),
                    spp=prog[-1]["spp"], ms_per_frame_last_chunk=round(last, 3),
                    wall_s_with_compile=round(wall, 3))
        if rc != 0 or img.shape != (700, 700, 3) or not 0.05 < img.mean() < 0.95:
            raise AssertionError("cli render preview produced no plausible image")

    def offline_grid1m(self):
        import math

        sys.path.insert(0, REPO)
        import bench

        t0 = time.perf_counter()
        res = bench.main(["--scene", "grid1m", "--width", "1024", "--height", "1024",
                          "--depth", "6", "--steps", "2", "--warmup", "1"])
        det = res["detail"]
        self.report("bench_grid1m", accel=det["accel"], ms_per_frame=det["ms_per_frame"],
                    rays_per_sec=res["value"], bvh_build_s=det["bvh_build_s"],
                    finite=det["finite"], wall_s_with_build=round(time.perf_counter() - t0, 3))
        if not (det["finite"] and res["value"] > 0 and math.isfinite(det["ms_per_frame"])):
            raise AssertionError("grid1m frame not finite")

    def optimize(self):
        import numpy as np

        from caitlyn import cli

        t0 = time.perf_counter()
        rc = cli.main(["optimize", os.path.join(REPO, "scenes", "cornell_disney.toml"),
                       "--width", "256", "--height", "256", "--steps", "8",
                       # start brighter than the truth: the 1-spp loss's
                       # noise floor then falls with the error instead of
                       # rising as the albedo recovers
                       "--perturb", "1.3",
                       "-o", os.path.join(self.tmp, "params.npz")])
        losses = self.log.of("opt_losses")[-1]["losses"]
        self.report("cli_optimize", rc=rc, losses=losses,
                    wall_s_with_compile=round(time.perf_counter() - t0, 3))
        if rc != 0 or not np.isfinite(losses).all() or not (
            np.mean(losses[-2:]) < np.mean(losses[:2])
        ):
            raise AssertionError("optimize loss not finite or not falling")

    # -- four cards ---------------------------------------------------------

    def sharded(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from caitlyn.core.types import RenderOptions
        from caitlyn.io.builtin_scenes import builtin_camera, displaced_grid
        from caitlyn.parallel.mesh import make_mesh
        from caitlyn.parallel.render import (
            init_sharded_state, sharded_render_step, sharded_train_step,
        )
        from caitlyn.render import progressive
        from caitlyn.scene import required_stack, scene_families, upload_scene

        scene, _ = displaced_grid(resolution=224)
        cam = builtin_camera("grid")
        ds = upload_scene(scene, accel="bvh2")
        w = h = 256
        opts = RenderOptions(width=w, height=h, max_depth=3, accel="bvh2",
                             families=scene_families(scene),
                             max_stack=required_stack(ds))
        devs = jax.devices()
        for shape in ((4, 1), (2, 2)):
            mesh = make_mesh(devs, shape=shape)
            t0 = time.perf_counter()
            st = sharded_render_step(ds, cam, init_sharded_state(mesh, w, h, seed=3),
                                     mesh, w, h, opts)
            sharded = np.asarray(st.accum)[: w * h]
            wall = time.perf_counter() - t0
            one = progressive.init_state(w, h, seed=3)
            for _ in range(shape[1]):
                one = progressive.render_step(ds, cam, one, w, h, opts)
            one = np.asarray(one.accum)
            equal = bool(np.array_equal(sharded, one))
            self.report("sharded_render", mesh=list(shape), bitwise_equal=equal,
                        max_abs_diff=float(np.abs(sharded - one).max()),
                        wall_s_with_compile=round(wall, 3))
            if not equal:
                raise AssertionError(f"sharded render {shape} differs from one card")

        mesh = make_mesh(devs, shape=(2, 2))
        st = sharded_render_step(ds, cam, init_sharded_state(mesh, w, h, seed=7),
                                 mesh, w, h, opts)
        params = {"albedo": ds.scene.materials.albedo.at[:, :3].mul(0.5)}
        _, loss = sharded_train_step(params, ds, cam, st.accum / 2, jax.random.PRNGKey(1),
                                     jnp.int32(0), mesh, w, h, opts)
        self.report("sharded_train_step", mesh=[2, 2], loss=float(loss))
        if not np.isfinite(float(loss)):
            raise AssertionError("sharded train step loss not finite")

    def mesh_cli(self):
        from caitlyn import cli
        from caitlyn.io.image import load_png

        out = os.path.join(self.tmp, "mesh.png")
        rc = cli.main(["render", os.path.join(REPO, "scenes", "cornell.toml"),
                       "--mesh", "auto", "--spp", "4", "-o", out])
        img = load_png(out)
        rec = self.log.of("mesh_render")[-1]
        self.report("cli_render_mesh", rc=rc, mesh=rec["mesh"], spp=rec["spp"],
                    step_ms_total=rec["step"], mean=float(img.mean()))
        if rc != 0 or not 0.05 < img.mean() < 0.95:
            raise AssertionError("cli render --mesh produced no plausible image")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX's devices are {devices}", file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"--devices {args.devices} but JAX sees {len(devices)}", file=sys.stderr)
        return 2

    from caitlyn.utils import compile_cache

    cache = compile_cache.configure()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    smoke = Smoke(card)
    if args.devices == 4:
        phases = [("sharded", smoke.sharded), ("mesh_cli", smoke.mesh_cli)]
    else:
        from caitlyn.io.builtin_scenes import (
            cornell_box, displaced_grid, random_triangle_soup,
        )

        phases = [
            ("kernel_build", smoke.kernel_build),
            ("parity_cornell", lambda: smoke.parity(
                "cornell", cornell_box()[0], "cornell", 700, 1 << 20)),
            ("parity_soup20k", lambda: smoke.parity(
                "soup20k", random_triangle_soup(20000)[0], "soup", 700, 1 << 14)),
            ("parity_grid100k", lambda: smoke.parity(
                "grid100k", displaced_grid(resolution=224)[0], "grid", 700, 1 << 13)),
            ("parity_grid1m", lambda: smoke.parity(
                "grid1m", displaced_grid(resolution=708)[0], "grid", 256, 1 << 12)),
            ("golden", smoke.golden),
            ("cli_render_preview", smoke.preview),
            ("bench_grid1m", smoke.offline_grid1m),
            ("cli_optimize", smoke.optimize),
        ]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException:
            print(f"FAILED phase {name}", file=sys.stderr, flush=True)
            raise
        print(f"phase {name} passed in {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s | {card}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
