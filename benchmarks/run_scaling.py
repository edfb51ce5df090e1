#!/usr/bin/env python
"""Scaling harness: rays/s per device at 1 device vs the full mesh.

The BASELINE >=85% scaling target's measurement tool
(parallel.distributed.scaling_report).  With --virtual-devices it runs on
a virtual CPU mesh (the same shard_map code path the cards take; the number
there checks WIRING, not hardware scaling — virtual devices share one
physical CPU, so don't read its efficiency against the 85% bar).  On the
cards of one host, run with no flags.

    python benchmarks/run_scaling.py --virtual-devices 8 --out scaling.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--scene", default="cornell", choices=["cornell", "grid100k"])
    ap.add_argument("--accel", default="bvh2")
    ap.add_argument(
        "--virtual-devices", type=int, default=0,
        help="force an N-device virtual CPU mesh (the CI wiring check); "
        "0 = use the environment's real devices",
    )
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.virtual_devices:
        # Must win over a pre-imported jax, for which the JAX_PLATFORMS
        # env var alone is too late (same strategy as tests/conftest.py).
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.virtual_devices}"
            ).strip()
        import jax as _jax

        _jax.config.update("jax_platforms", "cpu")

    # Multi-host wiring first — before any backend query (see
    # parallel.distributed.init_distributed).
    from caitlyn.parallel.distributed import (
        init_distributed,
        scaling_report,
    )

    pidx, pcount = init_distributed()

    import jax

    from caitlyn.core.types import RenderOptions
    from caitlyn.io import builtin_scenes
    from caitlyn.scene import required_stack, scene_families, upload_scene

    if args.scene == "cornell":
        scene, _ = builtin_scenes.cornell_box()
        camera = builtin_scenes.builtin_camera("cornell")
    else:
        scene, _ = builtin_scenes.displaced_grid(resolution=224)
        camera = builtin_scenes.builtin_camera("grid")
    ds = upload_scene(scene, accel=args.accel)
    options = RenderOptions(
        width=args.width, height=args.height, max_depth=args.depth,
        accel=args.accel, families=scene_families(scene),
        max_stack=required_stack(ds),
    )
    rep = scaling_report(ds, camera, options, args.width, args.height, args.spp)
    rep.update(
        {
            "scene": args.scene,
            "resolution": [args.width, args.height],
            "max_depth": args.depth,
            "accel": args.accel,
            "process_count": pcount,
            "backend": jax.default_backend(),
            "note": (
                "virtual CPU mesh: wiring check only — devices share one "
                "physical CPU, efficiency is not hardware scaling"
                if jax.default_backend() == "cpu"
                else "hardware measurement"
            ),
        }
    )
    out = json.dumps(rep, indent=2)
    print(out)
    if args.out and pidx == 0:
        with open(args.out, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
