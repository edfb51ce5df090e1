"""Which ray-query implementation runs, decided here and nowhere else.

The choice depends on what the code can observe: the platform JAX traces
for.  There is no silent fallback: on a GPU the bvh2/sbvh queries run the
CUDA kernel and fail if it cannot be built; on the CPU (the tests) they run
the XLA reference.  Any other platform is refused.

`auto` is the binary BVH at every scene size: on the H100 the kernel beat
the dense all-pairs sweep both at 36 triangles (cornell) and at 2,002
(PERF.md), so the sweep is no longer the small-scene path; it stays
as `--accel brute`, the reference the traversals are tested against.

    accel   cpu                      gpu
    brute   ops/intersect (dense)    ops/intersect (dense)
    bvh2    ops/traverse_xla         ops/traverse_cuda (kernel)
    sbvh    ops/traverse_xla         ops/traverse_cuda (kernel)
    cwbvh   ops/traverse_cwbvh       ops/traverse_cwbvh (format parity)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from caitlyn.ops import intersect as isect

ACCELS = ("brute", "bvh2", "sbvh", "cwbvh")
AUTO_ACCEL = "bvh2"  # what `auto` means, for every scene


def select(platform: str, accel: str = "auto") -> str:
    """Implementation name for (platform, accel): one of "dense",
    "xla_bvh", "cuda_bvh", "xla_cwbvh"."""
    if accel == "auto":
        accel = AUTO_ACCEL
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r} (expected auto or one of {ACCELS})")
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"no ray-query implementation for platform {platform!r}")
    if accel == "brute":
        return "dense"
    if accel == "cwbvh":
        return "xla_cwbvh"
    return "cuda_bvh" if platform == "gpu" else "xla_bvh"


def _check_stack(ds, max_stack: int) -> None:
    """Trace-time stack guard for the binary-BVH traversals.

    ds.tree_depth is static pytree metadata (a Python int at trace time),
    so a stack the build can overflow raises here, at the first trace,
    instead of returning wrong hits the way the reference's fixed
    12/16-deep stacks do (`path_trace.fs:513,674`).  Size options with
    `options._replace(max_stack=scene.required_stack(ds))`."""
    depth = getattr(ds, "tree_depth", 0)
    if depth + 1 > max_stack:
        raise ValueError(
            f"BVH tree depth {depth} needs a traversal stack of "
            f"{depth + 1} slots but options.max_stack={max_stack}; "
            "set options = options._replace(max_stack="
            "caitlyn.scene.required_stack(ds))"
        )


def _impl(options) -> str:
    return select(jax.default_backend(), options.accel)


def closest(ds, o, d, active, options):
    """Closest hit per ray: (t, tri, u, v); tri = -1 on a miss or an
    inactive lane.  Not differentiable: pass detached inputs."""
    sc = ds.scene
    impl = _impl(options)
    if impl == "dense":
        t, tri, u, v = isect.intersect_brute(o, d, sc.vertices, sc.tri_v)
        return t, jnp.where(active, tri, -1), u, v
    if impl == "xla_cwbvh":
        from caitlyn.ops.traverse_cwbvh import cwbvh_closest

        t, tri, u, v = cwbvh_closest(o, d, active, ds.cw_nodes, ds.cw_tris)
        return t, jnp.where(active, tri, -1), u, v
    _check_stack(ds, options.max_stack)
    if impl == "cuda_bvh":
        from caitlyn.ops import traverse_cuda

        return traverse_cuda.closest(
            o, d, active, ds.bvh_nodes, sc.vertices, sc.tri_v, options.max_stack
        )
    from caitlyn.ops.traverse_xla import traverse_closest

    return traverse_closest(
        o, d, active, ds.node_bounds, ds.node_meta, sc.vertices, sc.tri_v,
        max_leaf=options.max_leaf, max_stack=options.max_stack,
    )


def anyhit(ds, o, d, t_max, active, options):
    """Occlusion per ray in [0, t_max): (N,) bool, False on inactive lanes."""
    sc = ds.scene
    impl = _impl(options)
    if impl == "dense":
        occ = isect.occluded_brute(
            o, d, jnp.where(active, t_max, 0.0), sc.vertices, sc.tri_v
        )
        return occ & active
    if impl == "xla_cwbvh":
        from caitlyn.ops.traverse_cwbvh import cwbvh_anyhit

        return cwbvh_anyhit(o, d, t_max, active, ds.cw_nodes, ds.cw_tris)
    _check_stack(ds, options.max_stack)
    if impl == "cuda_bvh":
        from caitlyn.ops import traverse_cuda

        return traverse_cuda.anyhit(
            o, d, t_max, active, ds.bvh_nodes, sc.vertices, sc.tri_v,
            options.max_stack,
        )
    from caitlyn.ops.traverse_xla import traverse_anyhit

    return traverse_anyhit(
        o, d, t_max, active, ds.node_bounds, ds.node_meta, sc.vertices,
        sc.tri_v, max_leaf=options.max_leaf, max_stack=options.max_stack,
    )
