"""Wavefront BVH traversal in pure XLA (jnp + lax.while_loop).

The reference's traversal is a per-fragment scalar stack machine
(`/root/reference/Shader/path_trace.fs:511-667` closest-hit,
`:669-819` any-hit).  XLA has no per-lane program counter, so the
formulation here is a *vectorized* stack machine: every ray in the
batch carries its own (node, stack-pointer, stack) state as dense arrays,
and one `lax.while_loop` steps all rays together with masked updates until
every lane has terminated.  Each step does, per lane:

  inner node: 2 slab tests on the children (near-child-first push ordering,
              the reference's `node_offset` trick, path_trace.fs:577-581)
  leaf node:  a K-wide masked Möller–Trumbore block over the leaf's
              contiguous triangle range

Node/triangle fetches are XLA gathers from device-resident arrays.  Lanes
diverge in traversal length; the loop runs until the longest lane finishes.
This is the CPU implementation and the reference the CUDA kernel
(ops/traverse_cuda.py) is checked against; ops/traversal.py chooses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from caitlyn.ops import intersect as isect

INF = 1e9


def _fetch_children_hits(o, d_inv, t_limit, left, node_bounds):
    """Slab-test both children (left, left+1) of an inner node batch.

    Returns (hit_l, hit_r, near_l, near_r)."""
    nn = node_bounds.shape[0]
    bl = node_bounds[jnp.clip(left, 0, nn - 1)]  # (N, 6)
    br = node_bounds[jnp.clip(left + 1, 0, nn - 1)]
    tl_near, tl_far = isect.slab_test(o, d_inv, bl[:, :3], bl[:, 3:])
    tr_near, tr_far = isect.slab_test(o, d_inv, br[:, :3], br[:, 3:])
    # Reference acceptance: th > 0 && th >= tl && tl < t_best
    # (path_trace.fs:562-563).
    hit_l = (tl_far > 0) & (tl_far >= tl_near) & (tl_near < t_limit)
    hit_r = (tr_far > 0) & (tr_far >= tr_near) & (tr_near < t_limit)
    return hit_l, hit_r, tl_near, tr_near


@partial(jax.jit, static_argnames=("max_leaf", "max_stack"))
def traverse_closest(
    o,
    d,
    active,
    node_bounds,
    node_meta,
    verts,
    tri_v,
    max_leaf: int = 4,
    max_stack: int = 32,
):
    """Closest-hit traversal for a ray batch.

    o, d:       (N, 3) f32
    active:     (N,) bool — inactive lanes return miss immediately
    node_bounds (Nn, 6) f32, node_meta (Nn, 2) i32 — accel.bvh.FlatBVH arrays
    verts (V,3) f32, tri_v (T,4) i32 — triangle soup (already leaf-ordered)

    Returns (t, tri, u, v); tri = -1 on miss.
    """
    n = o.shape[0]
    d_inv = 1.0 / d
    n_idx = jnp.arange(n)

    state = dict(
        ind=jnp.where(active, 0, -1).astype(jnp.int32),
        ptr=jnp.zeros(n, jnp.int32),
        stack=jnp.full((n, max_stack), -1, jnp.int32),
        t=jnp.full(n, INF, jnp.float32),
        tri=jnp.full(n, -1, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
        iters=jnp.int32(0),
    )

    def cond(s):
        return jnp.any(s["ind"] > -1)

    def body(s):
        lane = s["ind"] > -1
        node = jnp.maximum(s["ind"], 0)
        meta = node_meta[node]  # (N, 2)
        left = meta[:, 0]
        rng = meta[:, 1]
        is_leaf = lane & (rng > 0)
        is_inner = lane & (rng == 0)

        # --- inner: test children, pick near-first, maybe push far child
        hit_l, hit_r, near_l, near_r = _fetch_children_hits(
            o, d_inv, s["t"], left, node_bounds
        )
        hit_l = hit_l & is_inner
        hit_r = hit_r & is_inner
        both = hit_l & hit_r
        # near-first: go to the closer child, push the farther one
        go_right_first = both & (near_l > near_r)
        next_inner = jnp.where(
            hit_l & ~go_right_first, left, jnp.where(hit_r, left + 1, -1)
        )
        push_val = jnp.where(go_right_first, left, left + 1)
        do_push = both

        # --- leaf: K-wide triangle block
        k = jnp.arange(max_leaf, dtype=jnp.int32)
        tri_idx = left[:, None] + k[None, :]
        valid = is_leaf[:, None] & (k[None, :] < rng[:, None])
        best = isect.intersect_leaf_triangles(
            o, d, tri_idx, valid, verts, tri_v,
            {"t": s["t"], "tri": s["tri"], "u": s["u"], "v": s["v"]},
        )

        # --- stack ops: push (inner both-hit) then advance or pop
        ptr = s["ptr"]
        stack = s["stack"]
        slot = jnp.minimum(ptr, max_stack - 1)
        cur_slot_val = stack[n_idx, slot]
        stack = stack.at[n_idx, slot].set(
            jnp.where(do_push, push_val, cur_slot_val)
        )
        ptr = jnp.where(do_push, ptr + 1, ptr)

        # next node: inner w/ hit → child; else pop (leaf lanes always pop)
        descend = is_inner & (next_inner >= 0)
        need_pop = lane & ~descend
        pop_slot = jnp.maximum(ptr - 1, 0)
        popped = jnp.where(ptr > 0, stack[n_idx, pop_slot], -1)
        new_ind = jnp.where(
            descend, next_inner, jnp.where(need_pop, popped, s["ind"])
        )
        new_ptr = jnp.where(need_pop & (ptr > 0), ptr - 1, ptr)

        return dict(
            ind=new_ind.astype(jnp.int32),
            ptr=new_ptr,
            stack=stack,
            t=best["t"],
            tri=best["tri"],
            u=best["u"],
            v=best["v"],
            iters=s["iters"] + 1,
        )

    out = lax.while_loop(cond, body, state)
    miss = out["t"] >= INF
    return out["t"], jnp.where(miss, -1, out["tri"]), out["u"], out["v"]


@partial(jax.jit, static_argnames=("max_leaf", "max_stack"))
def traverse_anyhit(
    o,
    d,
    t_max,
    active,
    node_bounds,
    node_meta,
    verts,
    tri_v,
    max_leaf: int = 4,
    max_stack: int = 32,
):
    """Any-hit (shadow) traversal: returns occluded (N,) bool.

    A lane terminates the moment it finds any intersection in [0, t_max)
    (the reference's early-out, `path_trace.fs:703-708`)."""
    n = o.shape[0]
    d_inv = 1.0 / d
    n_idx = jnp.arange(n)

    state = dict(
        ind=jnp.where(active, 0, -1).astype(jnp.int32),
        ptr=jnp.zeros(n, jnp.int32),
        stack=jnp.full((n, max_stack), -1, jnp.int32),
        occluded=jnp.zeros(n, bool),
    )

    def cond(s):
        return jnp.any(s["ind"] > -1)

    def body(s):
        lane = s["ind"] > -1
        node = jnp.maximum(s["ind"], 0)
        meta = node_meta[node]
        left = meta[:, 0]
        rng = meta[:, 1]
        is_leaf = lane & (rng > 0)
        is_inner = lane & (rng == 0)

        hit_l, hit_r, near_l, near_r = _fetch_children_hits(
            o, d_inv, t_max, left, node_bounds
        )
        hit_l = hit_l & is_inner
        hit_r = hit_r & is_inner
        both = hit_l & hit_r
        go_right_first = both & (near_l > near_r)
        next_inner = jnp.where(
            hit_l & ~go_right_first, left, jnp.where(hit_r, left + 1, -1)
        )
        push_val = jnp.where(go_right_first, left, left + 1)
        do_push = both

        k = jnp.arange(max_leaf, dtype=jnp.int32)
        tri_idx = jnp.clip(left[:, None] + k[None, :], 0, tri_v.shape[0] - 1)
        valid = is_leaf[:, None] & (k[None, :] < rng[:, None])
        vid = tri_v[tri_idx]
        v0 = verts[vid[..., 0]]
        e1 = verts[vid[..., 1]] - v0
        e2 = verts[vid[..., 2]] - v0
        hit, _, _, _ = isect.moller_trumbore(
            o[:, None, :], d[:, None, :], v0, e1, e2, t_max[:, None]
        )
        found = (hit & valid).any(axis=1)
        occluded = s["occluded"] | found

        ptr = s["ptr"]
        stack = s["stack"]
        slot = jnp.minimum(ptr, max_stack - 1)
        stack = stack.at[n_idx, slot].set(
            jnp.where(do_push, push_val, stack[n_idx, slot])
        )
        ptr = jnp.where(do_push, ptr + 1, ptr)

        descend = is_inner & (next_inner >= 0)
        need_pop = lane & ~descend
        pop_slot = jnp.maximum(ptr - 1, 0)
        popped = jnp.where(ptr > 0, stack[n_idx, pop_slot], -1)
        new_ind = jnp.where(
            descend, next_inner, jnp.where(need_pop, popped, s["ind"])
        )
        new_ptr = jnp.where(need_pop & (ptr > 0), ptr - 1, ptr)
        # early-out: occluded lanes stop traversing
        new_ind = jnp.where(occluded, -1, new_ind)

        return dict(
            ind=new_ind.astype(jnp.int32),
            ptr=new_ptr,
            stack=stack,
            occluded=occluded,
        )

    out = lax.while_loop(cond, body, state)
    return out["occluded"]
