"""SBVH — spatial-split BVH builder (Stich et al. 2009 family).

Capability-matched to the reference's SBVH (`/root/reference/Caitlyn/
sbvh.h:391-569`): per node it considers the best *object* split (centroid
binning, accel/bvh.py) and, when the object split's children overlap by
more than `split_alpha` × root area (`sbvh.h:96,120,258-263`), also the
best *spatial* split — a chopped-binning sweep where references straddling
a bin plane are clipped and may be **duplicated** into both children, with
the reference-unsplitting heuristic (compare unsplit-left / unsplit-right
/ duplicate SAH, `sbvh.h:523-566`).

Differences from the reference, chosen for a vectorized host pass:

* 64 bins instead of 256 (`sbvh.h:17`) — binning is O(bins·axes) vectorized
  NumPy per node, and 64 bins already captures the split-plane optimum on
  the benchmark meshes.
* Chopped **box** clipping: a straddling reference's bin contribution is
  its AABB clipped to the bin slab, where the reference clips the actual
  triangle polygon (`split_reference`, `sbvh.h:391-422`).  Box clipping is
  conservative (slightly looser child bounds, identical correctness) and
  fully vectorizable.
* A global duplication cap (`max_dup_ratio`) bounds memory; the reference
  relies only on the min-overlap gate.

Output is a standard `FlatBVH` whose `tri_order` is a *gather list* (length
≥ T, with duplicates) rather than a permutation — `reorder_scene` then
materializes the duplicated triangle array, and every consumer (binary
traversal, CUDA kernel, CWBVH) works unchanged; a triangle simply lives in
every leaf whose spatial bin it straddled.
"""

from __future__ import annotations

import numpy as np

from caitlyn.accel.bvh import FlatBVH, _Tree, _flatten

NBINS_OBJ = 32
NBINS_SPATIAL = 64


def _area(mn, mx):
    d = np.maximum(mx - mn, 0.0)
    if d.ndim == 1:
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def _object_split(cent, bmin, bmax):
    """Binned object split (same objective as accel.bvh._sah_split).
    Returns (cost, go_left mask, left_box, right_box) or (inf, ...)."""
    n = cent.shape[0]
    cmin = cent.min(axis=0)
    cmax = cent.max(axis=0)
    extent = cmax - cmin
    best = (np.inf, None, None, None)
    if not np.any(extent > 0):
        return best
    scale = np.where(extent > 0, NBINS_OBJ / np.maximum(extent, 1e-30), 0.0)
    bin_id = np.clip(((cent - cmin) * scale).astype(np.int32), 0, NBINS_OBJ - 1)
    for axis in range(3):
        if extent[axis] <= 0:
            continue
        ids = bin_id[:, axis]
        counts = np.bincount(ids, minlength=NBINS_OBJ)
        bmn = np.full((NBINS_OBJ, 3), np.inf, np.float32)
        bmx = np.full((NBINS_OBJ, 3), -np.inf, np.float32)
        np.minimum.at(bmn, ids, bmin)
        np.maximum.at(bmx, ids, bmax)
        lmn = np.minimum.accumulate(bmn, axis=0)[:-1]
        lmx = np.maximum.accumulate(bmx, axis=0)[:-1]
        rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1][1:]
        rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1][1:]
        lcnt = np.cumsum(counts)[:-1]
        rcnt = n - lcnt
        cost = _area(lmn, lmx) * lcnt + _area(rmn, rmx) * rcnt
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (
                float(cost[k]),
                ids <= k,
                (lmn[k].copy(), lmx[k].copy()),
                (rmn[k].copy(), rmx[k].copy()),
            )
    return best


def _spatial_split(bmin, bmax, node_min, node_max):
    """Chopped-binning spatial split over the node bounds.

    Returns (cost, axis, plane) or (inf, -1, 0) — cost uses enter/exit
    counts like the reference (`sbvh.h:463-493`)."""
    n = bmin.shape[0]
    extent = node_max - node_min
    best = (np.inf, -1, 0.0)
    for axis in range(3):
        if extent[axis] <= 0:
            continue
        width = extent[axis] / NBINS_SPATIAL
        inv_w = 1.0 / width
        first = np.clip(((bmin[:, axis] - node_min[axis]) * inv_w).astype(np.int32), 0, NBINS_SPATIAL - 1)
        last = np.clip(((bmax[:, axis] - node_min[axis]) * inv_w).astype(np.int32), first, NBINS_SPATIAL - 1)
        enter = np.bincount(first, minlength=NBINS_SPATIAL)
        exit_ = np.bincount(last, minlength=NBINS_SPATIAL)
        # Per-bin clipped-box bounds: each ref contributes its AABB clipped
        # to every bin slab it spans.  Vectorize via a (ref, bin) expansion
        # bounded by sum(spans); spans are short for reasonable meshes.
        spans = last - first + 1
        total = int(spans.sum())
        ref_ids = np.repeat(np.arange(n), spans)
        # bin index within each ref's span
        offs = np.concatenate([np.arange(s) for s in spans]) if total else np.zeros(0, np.int64)
        bins = first[ref_ids] + offs
        lo = node_min[axis] + bins * width
        hi = lo + width
        cb_min = bmin[ref_ids].copy()
        cb_max = bmax[ref_ids].copy()
        cb_min[:, axis] = np.maximum(cb_min[:, axis], lo)
        cb_max[:, axis] = np.minimum(cb_max[:, axis], hi)
        bmn = np.full((NBINS_SPATIAL, 3), np.inf, np.float32)
        bmx = np.full((NBINS_SPATIAL, 3), -np.inf, np.float32)
        np.minimum.at(bmn, bins, cb_min)
        np.maximum.at(bmx, bins, cb_max)

        lmn = np.minimum.accumulate(bmn, axis=0)[:-1]
        lmx = np.maximum.accumulate(bmx, axis=0)[:-1]
        rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1][1:]
        rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1][1:]
        lcnt = np.cumsum(enter)[:-1]
        rcnt = n - np.cumsum(exit_)[:-1]
        cost = _area(lmn, lmx) * lcnt + _area(rmn, rmx) * rcnt
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best[0]:
            best = (float(cost[k]), axis, float(node_min[axis] + (k + 1) * width))
    return best


def _perform_spatial(ids, bmin, bmax, axis, plane):
    """Partition refs about the plane with the unsplit heuristic
    (`sbvh.h:523-566`), duplicating straddlers (box-clipped)."""
    fully_left = bmax[:, axis] <= plane
    fully_right = bmin[:, axis] >= plane
    straddle = ~fully_left & ~fully_right

    l_ids = [ids[fully_left]]
    l_bmin = [bmin[fully_left]]
    l_bmax = [bmax[fully_left]]
    r_ids = [ids[fully_right]]
    r_bmin = [bmin[fully_right]]
    r_bmax = [bmax[fully_right]]

    lb_min = bmin[fully_left].min(axis=0) if fully_left.any() else np.full(3, np.inf, np.float32)
    lb_max = bmax[fully_left].max(axis=0) if fully_left.any() else np.full(3, -np.inf, np.float32)
    rb_min = bmin[fully_right].min(axis=0) if fully_right.any() else np.full(3, np.inf, np.float32)
    rb_max = bmax[fully_right].max(axis=0) if fully_right.any() else np.full(3, -np.inf, np.float32)

    if straddle.any():
        s_ids = ids[straddle]
        s_bmin = bmin[straddle]
        s_bmax = bmax[straddle]
        # clipped halves
        cl_max = s_bmax.copy()
        cl_max[:, axis] = np.minimum(cl_max[:, axis], plane)
        cr_min = s_bmin.copy()
        cr_min[:, axis] = np.maximum(cr_min[:, axis], plane)

        lac = sum(len(x) for x in l_ids)
        rac = sum(len(x) for x in r_ids)
        # Vectorized unsplit heuristic (evaluated against the committed
        # left/right bounds rather than the reference's sequential greedy
        # update — same objective, order-independent).
        lub_min = np.minimum(lb_min, s_bmin)
        lub_max = np.maximum(lb_max, s_bmax)
        rub_min = np.minimum(rb_min, s_bmin)
        rub_max = np.maximum(rb_max, s_bmax)
        ldb_min = np.minimum(lb_min, s_bmin)
        ldb_max = np.maximum(lb_max, cl_max)
        rdb_min = np.minimum(rb_min, cr_min)
        rdb_max = np.maximum(rb_max, s_bmax)

        unsplit_l = _area(lub_min, lub_max) * (lac + 1) + _area(rb_min, rb_max) * rac
        unsplit_r = _area(lb_min, lb_max) * lac + _area(rub_min, rub_max) * (rac + 1)
        dup = _area(ldb_min, ldb_max) * (lac + 1) + _area(rdb_min, rdb_max) * (rac + 1)

        choice = np.argmin(np.stack([unsplit_l, unsplit_r, dup]), axis=0)
        go_l = choice == 0
        go_r = choice == 1
        go_d = choice == 2

        if go_l.any():
            l_ids.append(s_ids[go_l]); l_bmin.append(s_bmin[go_l]); l_bmax.append(s_bmax[go_l])
        if go_r.any():
            r_ids.append(s_ids[go_r]); r_bmin.append(s_bmin[go_r]); r_bmax.append(s_bmax[go_r])
        if go_d.any():
            l_ids.append(s_ids[go_d]); l_bmin.append(s_bmin[go_d]); l_bmax.append(cl_max[go_d])
            r_ids.append(s_ids[go_d]); r_bmin.append(cr_min[go_d]); r_bmax.append(s_bmax[go_d])

    def cat(parts):
        return np.concatenate([p for p in parts if len(p)], axis=0)

    return (
        (cat(l_ids), cat(l_bmin), cat(l_bmax)),
        (cat(r_ids), cat(r_bmin), cat(r_bmax)),
    )


def build_sbvh(
    vertices: np.ndarray,
    tri_v: np.ndarray,
    max_leaf: int = 4,
    split_alpha: float = 1e-5,
    max_dup_ratio: float = 1.6,
) -> FlatBVH:
    """Build the SBVH; `tri_order` is a gather list with duplicates."""
    t = tri_v.shape[0]
    v0 = vertices[tri_v[:, 0]]
    v1 = vertices[tri_v[:, 1]]
    v2 = vertices[tri_v[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)

    root_min = tri_min.min(axis=0) if t else np.zeros(3, np.float32)
    root_max = tri_max.max(axis=0) if t else np.zeros(3, np.float32)
    min_overlap = _area(root_min, root_max) * split_alpha
    max_refs = int(t * max_dup_ratio) + 16

    tree = _Tree()
    root = tree.add(root_min, root_max)
    order: list = []  # gather list, filled leaf by leaf
    total_refs = t

    # Stack entries carry their own ref arrays (ids may repeat).
    stack = [(root, np.arange(t, dtype=np.int32), tri_min.copy(), tri_max.copy())]

    while stack:
        node_id, ids, bmin, bmax = stack.pop()
        n = len(ids)
        nb_min = bmin.min(axis=0)
        nb_max = bmax.max(axis=0)
        tree.bmin[node_id] = nb_min
        tree.bmax[node_id] = nb_max

        if n <= max_leaf:
            tree.start[node_id] = len(order)
            tree.range[node_id] = n
            order.extend(ids.tolist())
            continue

        cent = (bmin + bmax) * 0.5
        obj_cost, go_left, lbox, rbox = _object_split(cent, bmin, bmax)

        use_spatial = False
        if obj_cost < np.inf and total_refs < max_refs:
            # Overlap gate (sbvh.h:258-263).
            omin = np.maximum(lbox[0], rbox[0])
            omax = np.minimum(lbox[1], rbox[1])
            if (omax > omin).all() and _area(omin, omax) >= min_overlap:
                sp_cost, sp_axis, sp_plane = _spatial_split(bmin, bmax, nb_min, nb_max)
                if sp_cost < obj_cost:
                    use_spatial = True
        elif obj_cost == np.inf:
            sp_cost, sp_axis, sp_plane = np.inf, -1, 0.0

        left_id = tree.add(None, None)
        right_id = tree.add(None, None)
        tree.left[node_id] = left_id
        tree.right[node_id] = right_id

        if use_spatial:
            (lid, lbm, lbx), (rid, rbm, rbx) = _perform_spatial(
                ids, bmin, bmax, sp_axis, sp_plane
            )
            if len(lid) == 0 or len(rid) == 0 or (len(lid) == n and len(rid) == n):
                use_spatial = False  # degenerate; fall back to object split
            else:
                total_refs += len(lid) + len(rid) - n
                stack.append((right_id, rid, rbm, rbx))
                stack.append((left_id, lid, lbm, lbx))
                continue

        if go_left is None:
            # Degenerate: median split by index.
            mid = n // 2
            sel = np.zeros(n, bool)
            sel[:mid] = True
            go_left = sel
        stack.append((right_id, ids[~go_left], bmin[~go_left], bmax[~go_left]))
        stack.append((left_id, ids[go_left], bmin[go_left], bmax[go_left]))

    bvh = _flatten(tree, np.asarray(order, np.int32))
    return bvh
