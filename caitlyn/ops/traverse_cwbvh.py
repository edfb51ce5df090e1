"""CWBVH 8-wide compressed traversal (vectorized stack machine, jnp).

The per-ray algorithm mirrors the reference's known-good GLSL decode
(`/root/reference/Shader/cwbvh.fs:346-616`): octant-inverse mask, MSB-first
child pop, popcount relative indexing, byte-sliced quantized slab tests —
re-expressed as masked whole-batch array ops (`jax.lax.clz` /
`population_count` replace findMSB/bitCount).  One improvement over the
per-fragment original: a node's triangle group is processed as a single
dense ≤24-wide Möller–Trumbore block (one chunky gather) instead of a
bit-scan loop — the whole low-24-bit hit mask resolves in one step.

Like the binary traversal this is a gather loop, but with ~3× fewer
iterations (8-wide tree) and one 80-byte node fetch per visit.  It is the
format-parity path of `--accel cwbvh`; the production accelerator is the
binary BVH (ops/traversal.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

INF = 1e9
STACK = 16  # LOCAL_STACK_SIZE (cwbvh.fs:374)
U32 = jnp.uint32


def _extract_byte(x, i: int):
    return (x >> U32(8 * i)) & U32(0xFF)


def _find_msb(x):
    """findMSB for uint32 (x != 0)."""
    return 31 - lax.clz(x.astype(jnp.int32)).astype(jnp.int32)


def _oct_inv4(d):
    """Octant-inverse replicated to 4 bytes (`cwbvh.fs:348-353`)."""
    o = (
        jnp.where(d[:, 0] < 0, U32(0), U32(0x04040404))
        | jnp.where(d[:, 1] < 0, U32(0), U32(0x02020202))
        | jnp.where(d[:, 2] < 0, U32(0), U32(0x01010101))
    )
    return o


def _node_intersect(o, d, d_inv, oct_inv4, max_t, node):
    """Intersect a ray batch against its fetched node8s
    (`cwbvh.fs:376-446`).  node: (N, 20) uint32.  Returns hit_mask (N,) u32:
    high byte = inner-child hits (slot^oct ordered), low 24 = triangle bits."""
    n = o.shape[0]
    p = lax.bitcast_convert_type(node[:, 0:3], jnp.float32)
    e_imask = node[:, 3]
    adj_inv = jnp.stack(
        [
            lax.bitcast_convert_type(_extract_byte(e_imask, 0) << U32(23), jnp.float32),
            lax.bitcast_convert_type(_extract_byte(e_imask, 1) << U32(23), jnp.float32),
            lax.bitcast_convert_type(_extract_byte(e_imask, 2) << U32(23), jnp.float32),
        ],
        axis=-1,
    ) * d_inv
    adj_org = (p - o) * d_inv

    hit_mask = jnp.zeros(n, U32)
    for half in range(2):  # children 0-3, then 4-7
        meta4 = node[:, 6 + half]
        is_inner4 = (meta4 & (meta4 << U32(1))) & U32(0x10101010)
        inner_mask4 = ((is_inner4 << U32(3)) >> U32(7) & U32(0x01010101)) * U32(0xFF)
        bit_index4 = (meta4 ^ (oct_inv4 & inner_mask4)) & U32(0x1F1F1F1F)
        child_bits4 = (meta4 >> U32(5)) & U32(0x07070707)

        q_lo_x = node[:, 8 + half]
        q_hi_x = node[:, 10 + half]
        q_lo_y = node[:, 12 + half]
        q_hi_y = node[:, 14 + half]
        q_lo_z = node[:, 16 + half]
        q_hi_z = node[:, 18 + half]

        neg_x = (d[:, 0] < 0)
        neg_y = (d[:, 1] < 0)
        neg_z = (d[:, 2] < 0)
        x_min = jnp.where(neg_x, q_hi_x, q_lo_x)
        x_max = jnp.where(neg_x, q_lo_x, q_hi_x)
        y_min = jnp.where(neg_y, q_hi_y, q_lo_y)
        y_max = jnp.where(neg_y, q_lo_y, q_hi_y)
        z_min = jnp.where(neg_z, q_hi_z, q_lo_z)
        z_max = jnp.where(neg_z, q_lo_z, q_hi_z)

        for j in range(4):
            tmin = jnp.maximum(
                jnp.maximum(
                    _extract_byte(x_min, j).astype(jnp.float32) * adj_inv[:, 0] + adj_org[:, 0],
                    _extract_byte(y_min, j).astype(jnp.float32) * adj_inv[:, 1] + adj_org[:, 1],
                ),
                _extract_byte(z_min, j).astype(jnp.float32) * adj_inv[:, 2] + adj_org[:, 2],
            )
            tmax = jnp.minimum(
                jnp.minimum(
                    _extract_byte(x_max, j).astype(jnp.float32) * adj_inv[:, 0] + adj_org[:, 0],
                    _extract_byte(y_max, j).astype(jnp.float32) * adj_inv[:, 1] + adj_org[:, 1],
                ),
                _extract_byte(z_max, j).astype(jnp.float32) * adj_inv[:, 2] + adj_org[:, 2],
            )
            # Reference quirks not replicated (cwbvh.fs:435-437): it takes
            # max() over the three far planes (admits false positives) and
            # culls on tmax < max_t (false *negatives* for nodes straddling
            # the current best — partially compensated by the first quirk).
            # Standard exact rule: overlap of [tmin, tmax] with [0, max_t).
            hit = (tmax >= 0.0) & (tmin < max_t) & (tmin <= tmax)
            child_bits = _extract_byte(child_bits4, j)
            bit_index = _extract_byte(bit_index4, j)
            hit_mask = hit_mask | jnp.where(hit, child_bits << bit_index, U32(0))
    return hit_mask


def _mt24(o, d, tri_base, tri_mask, packed_tris, t_best):
    """Dense ≤24-wide triangle block: test triangles tri_base+j for every
    set bit j of tri_mask.  packed_tris: (T, 9) f32 (v0, e1, e2)."""
    n = o.shape[0]
    k = jnp.arange(24, dtype=jnp.int32)
    idx = jnp.clip(tri_base[:, None].astype(jnp.int32) + k[None, :], 0, packed_tris.shape[0] - 1)
    tris = packed_tris[idx]  # (N, 24, 9)
    valid = ((tri_mask[:, None] >> k[None, :].astype(U32)) & U32(1)) == 1
    v0 = tris[..., 0:3]
    e1 = tris[..., 3:6]
    e2 = tris[..., 6:9]
    ob = o[:, None, :]
    db = d[:, None, :]
    pv = jnp.cross(db, e2)
    det = jnp.sum(e1 * pv, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    tv = ob - v0
    qv = jnp.cross(tv, e1)
    u = jnp.sum(tv * pv, axis=-1) * inv_det
    v = jnp.sum(db * qv, axis=-1) * inv_det
    t = jnp.sum(e2 * qv, axis=-1) * inv_det
    ok = valid & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0) & (t >= 0) & (t < t_best[:, None])
    t_cand = jnp.where(ok, t, INF)
    slot = jnp.argmin(t_cand, axis=1)
    n_idx = jnp.arange(n)
    return t_cand[n_idx, slot], idx[n_idx, slot], u[n_idx, slot], v[n_idx, slot]


def _traverse(o, d, active, nodes, packed_tris, t_limit, any_hit: bool):
    """t_limit: (N,) f32 — per-ray upper bound (INF for closest-hit)."""
    n = o.shape[0]
    n_idx = jnp.arange(n)
    d_inv = 1.0 / d
    oct_inv4 = _oct_inv4(d)

    state = dict(
        cg_x=jnp.zeros(n, U32),
        cg_y=jnp.where(active, U32(0x80000000), U32(0)),
        stack=jnp.zeros((n, STACK, 2), U32),
        sp=jnp.zeros(n, jnp.int32),
        t=t_limit,
        tri=jnp.full(n, -1, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
        occ=jnp.zeros(n, bool),
    )

    def cond(s):
        live = (s["sp"] > 0) | (s["cg_y"] != 0)
        if any_hit:
            live = live & ~s["occ"]
        return jnp.any(live)

    def body(s):
        cg_x, cg_y = s["cg_x"], s["cg_y"]
        lane = (s["sp"] > 0) | (cg_y != 0)
        if any_hit:
            lane = lane & ~s["occ"]

        is_node_group = (cg_y & U32(0xFF000000)) != 0

        # --- node-group path (cwbvh.fs:466-500)
        hits_imask = cg_y
        safe_imask = jnp.where(is_node_group, hits_imask, U32(0x80000000))
        child_off = _find_msb(safe_imask)
        cleared_y = cg_y & ~(U32(1) << child_off.astype(U32))
        push = is_node_group & ((cleared_y & U32(0xFF000000)) != 0) & lane
        sp = s["sp"]
        slot_i = jnp.minimum(sp, STACK - 1)
        stack = s["stack"]
        stack = stack.at[n_idx, slot_i, 0].set(jnp.where(push, cg_x, stack[n_idx, slot_i, 0]))
        stack = stack.at[n_idx, slot_i, 1].set(jnp.where(push, cleared_y, stack[n_idx, slot_i, 1]))
        sp = jnp.where(push, sp + 1, sp)

        slot_index = (child_off.astype(U32) - U32(24)) ^ (oct_inv4 & U32(0xFF))
        rel = lax.population_count(
            hits_imask & ~(U32(0xFFFFFFFF) << jnp.minimum(slot_index, U32(31)))
        )
        child_node_index = cg_x + rel

        fetch_idx = jnp.where(
            lane & is_node_group, child_node_index.astype(jnp.int32), 0
        )
        node = nodes[jnp.clip(fetch_idx, 0, nodes.shape[0] - 1)]  # (N, 20)

        hit_mask = _node_intersect(o, d, d_inv, oct_inv4, s["t"], node)
        imask = _extract_byte(node[:, 3], 3)
        ng_x = node[:, 4]
        tg_x = node[:, 5]
        ng_y = (hit_mask & U32(0xFF000000)) | imask
        tg_y = hit_mask & U32(0x00FFFFFF)

        # --- triangle-group path: cg IS a triangle group
        tg_x = jnp.where(is_node_group, tg_x, cg_x)
        tg_y = jnp.where(is_node_group, tg_y, cg_y)
        new_cg_x = jnp.where(is_node_group, ng_x, U32(0))
        new_cg_y = jnp.where(is_node_group, ng_y, U32(0))

        # --- process the whole triangle group densely
        do_tris = lane & (tg_y != 0)
        t_cand, tri_cand, u_cand, v_cand = _mt24(
            o, d, tg_x, jnp.where(do_tris, tg_y, U32(0)), packed_tris, s["t"]
        )
        better = do_tris & (t_cand < s["t"])
        t_new = jnp.where(better, t_cand, s["t"])
        tri_new = jnp.where(better, tri_cand, s["tri"])
        u_new = jnp.where(better, u_cand, s["u"])
        v_new = jnp.where(better, v_cand, s["v"])
        occ = s["occ"] | (better if any_hit else jnp.zeros(n, bool))

        # --- pop when the new group has no hit children (cwbvh.fs:520-525)
        empty = (new_cg_y & U32(0xFF000000)) == 0
        can_pop = empty & (sp > 0) & lane
        pop_slot = jnp.maximum(sp - 1, 0)
        new_cg_x = jnp.where(can_pop, stack[n_idx, pop_slot, 0], new_cg_x)
        new_cg_y = jnp.where(can_pop, stack[n_idx, pop_slot, 1], new_cg_y)
        sp = jnp.where(can_pop, sp - 1, sp)
        # lanes that are empty with empty stack terminate (cg_y = 0)
        new_cg_y = jnp.where(empty & ~can_pop, U32(0), new_cg_y)

        # inactive lanes keep state
        return dict(
            cg_x=jnp.where(lane, new_cg_x, cg_x),
            cg_y=jnp.where(lane, new_cg_y, cg_y),
            stack=stack,
            sp=jnp.where(lane, sp, s["sp"]),
            t=t_new,
            tri=tri_new,
            u=u_new,
            v=v_new,
            occ=occ,
        )

    out = lax.while_loop(cond, body, state)
    return out


@partial(jax.jit, static_argnames=())
def cwbvh_closest(o, d, active, cw_nodes, packed_tris):
    """Closest hit via CWBVH.  packed_tris: (T, 9) f32 — the scene's
    triangles in cwbvh order (scene ids == cwbvh slot ids after upload)."""
    t_limit = jnp.full(o.shape[0], INF, jnp.float32)
    out = _traverse(o, d, active, cw_nodes, packed_tris, t_limit, any_hit=False)
    hit = out["tri"] >= 0
    return jnp.where(hit, out["t"], INF), out["tri"], out["u"], out["v"]


@partial(jax.jit, static_argnames=())
def cwbvh_anyhit(o, d, t_max, active, cw_nodes, packed_tris):
    out = _traverse(o, d, active, cw_nodes, packed_tris, t_max, any_hit=True)
    return out["occ"]
