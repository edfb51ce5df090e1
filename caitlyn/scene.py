"""Device scene: host SceneArrays + acceleration structure, uploaded to
device memory.

The reference's CPU→GPU boundary is `gpu_data()` (`/root/reference/Caitlyn/
Scene.h:1000-1156`): flat arrays become GL texture-buffer objects.  Here it
is `jax.device_put` of the same flat arrays (optionally with an explicit
replicated sharding over a mesh — see parallel/).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from caitlyn.accel.bvh import FlatBVH, build_bvh, reorder_scene
from caitlyn.core.types import SceneArrays
from caitlyn.ops.traversal import ACCELS
from caitlyn.ops.traverse_cuda import pack_nodes


@jax.tree_util.register_pytree_node_class
class DeviceScene:
    """Scene arrays (triangle order = BVH leaf order) + flat BVH, on device.

    Array fields (pytree leaves):
      scene:       SceneArrays (fields are jnp arrays)
      node_bounds: (Nn, 6) f32 — FlatBVH boxes (XLA traversal)
      node_meta:   (Nn, 2) i32 — FlatBVH meta (XLA traversal)
      bvh_nodes:   (Nn, 16) f32 — the same tree as CUDA kernel node records
                   (ops/traverse_cuda.pack_nodes)
      cw_nodes:    (N8, 20) u32 — packed CWBVH node8s when the 8-wide
                   accelerator is built, else a (0, 20) placeholder
      cw_tris:     (T, 9) f32 — packed v0,e1,e2 in cwbvh order
      shade_tab:   (T, 50) f32 or None — fused shading table
                   (render/integrator._build_shade_table layout),
                   precomputed at upload for large scenes so each bounce
                   fetches all shading data with one row gather instead of
                   a dependent gather chain.  apply_params rebuilds it
                   differentiably during optimization.

    Static metadata (pytree aux — a plain Python int visible at trace
    time, NOT traced):
      tree_depth: depth of the binary flat BVH from the build.  The
        traversal dispatch (ops/traversal.py) checks tree_depth <
        options.max_stack when tracing the stack-based traversals, so a
        too-small stack raises loudly instead of silently clamping (the
        reference's fixed 12/16-deep stacks lose hits on deep trees with
        no signal, `path_trace.fs:513,674`).

    NOTE: the leaf width used at build time is a *static* render option
    (RenderOptions.max_leaf) so that jit-traced traversal shapes stay
    static.
    """

    _fields = (
        "scene", "node_bounds", "node_meta", "bvh_nodes", "cw_nodes",
        "cw_tris", "shade_tab",
    )
    __slots__ = _fields + ("tree_depth",)

    def __init__(self, *, tree_depth: int = 0, **kw):
        for f in self._fields:
            object.__setattr__(self, f, kw.pop(f))
        if kw:
            raise TypeError(f"unknown DeviceScene fields: {sorted(kw)}")
        object.__setattr__(self, "tree_depth", int(tree_depth))

    def _replace(self, **kw):
        """NamedTuple-style functional update (fields and/or tree_depth)."""
        cur = {f: getattr(self, f) for f in self._fields}
        cur["tree_depth"] = kw.pop("tree_depth", self.tree_depth)
        cur.update(kw)
        return DeviceScene(**cur)

    def tree_flatten(self):
        return (
            tuple(getattr(self, f) for f in self._fields),
            self.tree_depth,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(tree_depth=aux, **dict(zip(cls._fields, children)))

    def __repr__(self):
        return (
            f"DeviceScene(tree_depth={self.tree_depth}, "
            + ", ".join(f"{f}=..." for f in self._fields)
            + ")"
        )


def scene_families(scene_np: SceneArrays) -> tuple:
    """Classify which shading families the scene's materials actually use,
    for RenderOptions.families (static jit specialization — the integrator
    only traces the lobes the scene needs).

    Families: "lambert" (diffuse), "mirror" (delta reflection), "glass"
    (delta dielectric), "disney" (everything microfacet)."""
    from caitlyn.core.types import LAMBERT_TYPES, MaterialType

    types = set(int(t) for t in np.asarray(scene_np.materials.albedo[:, 3]))
    lambert_ids = {int(t) for t in LAMBERT_TYPES}
    glass_ids = {
        int(MaterialType.GLASS),
        int(MaterialType.GLASS_COLOR),
        int(MaterialType.GLASS_NO_REFRACT),
        int(MaterialType.ROUGH_DIELECTRIC),
        int(MaterialType.THIN_DIELECTRIC),
        int(MaterialType.THIN_SHEET),
    }
    mirror_ids = {int(MaterialType.MIRROR), int(MaterialType.CONDUCTOR)}
    fams = []
    if types & lambert_ids:
        fams.append("lambert")
    if types - lambert_ids - glass_ids - mirror_ids:
        fams.append("disney")
    if types & mirror_ids:
        fams.append("mirror")
    if types & glass_ids:
        fams.append("glass")
    return tuple(fams) if fams else ("lambert",)


def validate_scene(scene_np: SceneArrays) -> None:
    """Fail-fast structural validation of scene inputs (SURVEY §5 failure
    detection: the reference prints-and-continues on bad assets,
    `Scene.h:510-511,746-747`; a malformed scene here raises BEFORE the
    build so the error names the actual problem instead of surfacing as a
    garbage render or an out-of-range gather on device)."""
    v = np.asarray(scene_np.vertices)
    tv = np.asarray(scene_np.tri_v)
    if v.ndim != 2 or v.shape[1] != 3:
        raise ValueError(f"vertices must be (V, 3), got {v.shape}")
    if not np.isfinite(v).all():
        bad = np.argwhere(~np.isfinite(v).all(axis=1))[:5].ravel().tolist()
        raise ValueError(f"non-finite vertex coordinates at rows {bad}")
    if tv.ndim != 2 or tv.shape[1] != 4:
        raise ValueError(f"tri_v must be (T, 4), got {tv.shape}")
    if tv.shape[0]:
        idx = tv[:, :3]
        if idx.min() < 0 or idx.max() >= max(len(v), 1):
            raise ValueError(
                f"triangle vertex indices out of range [0, {len(v)}): "
                f"min {idx.min()}, max {idx.max()}"
            )
        m = np.asarray(scene_np.materials.albedo).shape[0]
        if tv[:, 3].min() < 0 or tv[:, 3].max() >= max(m, 1):
            raise ValueError(
                f"material indices out of range [0, {m}): "
                f"min {tv[:, 3].min()}, max {tv[:, 3].max()}"
            )
        vn = np.asarray(scene_np.normals)
        tn = np.asarray(scene_np.tri_vn)
        if len(vn) and len(tn):
            used = tn[tn[:, 3] == 1][:, :3]
            if used.size and (used.min() < 0 or used.max() >= len(vn)):
                raise ValueError(
                    f"normal indices out of range [0, {len(vn)})"
                )
    li = scene_np.lights
    if np.asarray(li.p).shape[0]:
        pdf = np.asarray(li.area_pdf)
        if not np.isfinite(pdf).all() or (pdf < 0).any():
            raise ValueError("light area/pdf table contains invalid values")


def required_stack(ds_or_meta) -> int:
    """Traversal stack size that provably cannot overflow for this build:
    the actual tree depth + 1 (floored at the historical default 32).

    The reference uses fixed 12/16-deep stacks and silently clamps on
    deeper trees (`path_trace.fs:513,674`) — wrong hits with no signal.
    Here the stack is a static jit parameter, so the CLI/bench size it
    from the build: ``options._replace(max_stack=required_stack(ds))``.
    Accepts a DeviceScene or a raw (Nn, 2) node_meta array."""
    if hasattr(ds_or_meta, "tree_depth"):
        return max(32, ds_or_meta.tree_depth + 1)
    from caitlyn.accel.bvh import tree_depth

    return max(32, tree_depth(np.asarray(ds_or_meta)) + 1)


# Scenes above this many triangles get the fused shading table at upload;
# smaller ones build it inside the trace, differentiable w.r.t. direct
# ds.scene edits.
SHADE_TABLE_AT_UPLOAD_TRIS = 2048


def upload_scene(
    scene_np: SceneArrays,
    accel: str = "bvh2",
    max_leaf: int = 4,
    bvh: Optional[FlatBVH] = None,
    device=None,
) -> DeviceScene:
    """Build the acceleration structure (host pass) and move everything to
    device memory.  `accel`: "brute" (no BVH), "bvh2"/"sbvh" (binary flat
    BVH) or "cwbvh" (reference-format 8-wide compressed); ops/traversal.py
    picks the implementation that walks it."""
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r} (expected one of {ACCELS})")
    validate_scene(scene_np)
    cw_nodes = np.zeros((0, 20), np.uint32)
    cw_tris = np.zeros((0, 9), np.float32)
    if accel == "brute" or scene_np.num_triangles == 0:
        bvh = FlatBVH(
            node_bounds=np.zeros((1, 6), np.float32),
            node_meta=np.array([[0, max(scene_np.num_triangles, 1)]], np.int32),
            tri_order=np.arange(scene_np.num_triangles, dtype=np.int32),
        )
        ordered = scene_np
    else:
        if accel == "cwbvh":
            # node8 leaf children hold at most 3 triangles (unary meta).
            max_leaf = min(max_leaf, 3)
        if bvh is None:
            if accel == "sbvh":
                from caitlyn.accel.sbvh import build_sbvh

                bvh = build_sbvh(scene_np.vertices, scene_np.tri_v, max_leaf=max_leaf)
            else:
                bvh = build_bvh(scene_np.vertices, scene_np.tri_v, max_leaf=max_leaf)
        ordered = reorder_scene(scene_np, bvh)
        if accel == "cwbvh":
            from caitlyn.accel.cwbvh import build_cwbvh

            cw = build_cwbvh(bvh, ordered.vertices, ordered.tri_v)
            cw_nodes = cw.nodes
            ordered = ordered._replace(
                tri_v=ordered.tri_v[cw.tri_order],
                tri_vn=ordered.tri_vn[cw.tri_order],
                tri_vt=ordered.tri_vt[cw.tri_order],
            )
            tv = ordered.tri_v
            p0 = ordered.vertices[tv[:, 0]]
            cw_tris = np.concatenate(
                [p0, ordered.vertices[tv[:, 1]] - p0, ordered.vertices[tv[:, 2]] - p0],
                axis=1,
            ).astype(np.float32)

    put = (lambda x: jax.device_put(x, device)) if device is not None else jax.device_put

    def to_dev(x):
        return put(jnp.asarray(x)) if x is not None else None

    from caitlyn.accel.bvh import tree_depth as _tree_depth

    depth = int(_tree_depth(np.asarray(bvh.node_meta)))

    dev_scene = jax.tree_util.tree_map(to_dev, ordered)
    if ordered.num_triangles > SHADE_TABLE_AT_UPLOAD_TRIS:
        # Large scenes: precompute the fused shading table once; large-
        # scene optimization goes through grad.inverse.apply_params, which
        # rebuilds it — callers mutating ds.scene directly on a big scene
        # must also refresh shade_tab (or set it to None to get the
        # in-trace build).
        from caitlyn.render.integrator import _build_shade_table

        shade_tab = _build_shade_table(dev_scene)
    else:
        shade_tab = None
    return DeviceScene(
        tree_depth=depth,
        scene=dev_scene,
        shade_tab=shade_tab,
        node_bounds=to_dev(bvh.node_bounds),
        node_meta=to_dev(bvh.node_meta),
        bvh_nodes=to_dev(pack_nodes(bvh.node_bounds, bvh.node_meta)),
        cw_nodes=to_dev(cw_nodes),
        cw_tris=to_dev(cw_tris),
    )
