"""BVH builder property tests + traversal ≡ brute-force equivalence.

Mirrors the test strategy SURVEY.md §4 prescribes: every triangle in
exactly one leaf range, parent boxes contain child boxes, flat layout has
right = left + 1 (implicit), and traversal over random rays returns exactly
the brute-force closest hit.
"""

import numpy as np
import jax.numpy as jnp

from caitlyn.accel.bvh import build_bvh, reorder_scene, sah_cost
from caitlyn.io.builtin_scenes import cornell_box, random_triangle_soup
from caitlyn.ops import intersect as isect
from caitlyn.ops.traverse_xla import traverse_anyhit, traverse_closest


def _scenes():
    s1, _ = cornell_box()
    s2, _ = random_triangle_soup(500, seed=3)
    return [("cornell", s1), ("soup500", s2)]


def test_bvh_invariants():
    for name, scene in _scenes():
        bvh = build_bvh(scene.vertices, scene.tri_v, max_leaf=4)
        t = scene.num_triangles
        leaf = bvh.is_leaf()
        # Every triangle in exactly one leaf range; ranges tile [0, T).
        starts = bvh.node_meta[leaf, 0]
        counts = bvh.node_meta[leaf, 1]
        covered = np.zeros(t, np.int32)
        for s, c in zip(starts, counts):
            covered[s : s + c] += 1
        assert (covered == 1).all(), name
        # tri_order is a permutation.
        assert sorted(bvh.tri_order.tolist()) == list(range(t))
        # Parent box contains child boxes (inner: children at left, left+1).
        inner = ~leaf
        left = bvh.node_meta[inner, 0]
        pb = bvh.node_bounds[inner]
        for child in (left, left + 1):
            cb = bvh.node_bounds[child]
            assert (cb[:, :3] >= pb[:, :3] - 1e-4).all(), name
            assert (cb[:, 3:] <= pb[:, 3:] + 1e-4).all(), name
        # Leaf sizes within bound.
        assert (counts <= 4).all() and (counts >= 1).all()
        # SAH cost is finite and positive.
        assert 0 < sah_cost(bvh) < 1e6


def _random_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo = scene.vertices.min(axis=0) - 1.0
    hi = scene.vertices.max(axis=0) + 1.0
    o = (rng.random((n, 3)).astype(np.float32)) * (hi - lo) + lo
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_traversal_matches_brute_force():
    for name, scene in _scenes():
        bvh = build_bvh(scene.vertices, scene.tri_v, max_leaf=4)
        scene_r = reorder_scene(scene, bvh)
        o, d = _random_rays(scene, 256, seed=7)
        verts = jnp.asarray(scene_r.vertices)
        tri_v = jnp.asarray(scene_r.tri_v)
        active = jnp.ones(o.shape[0], bool)

        t_b, tri_b, u_b, v_b = isect.intersect_brute(
            jnp.asarray(o), jnp.asarray(d), verts, tri_v
        )
        t_t, tri_t, u_t, v_t = traverse_closest(
            jnp.asarray(o),
            jnp.asarray(d),
            active,
            jnp.asarray(bvh.node_bounds),
            jnp.asarray(bvh.node_meta),
            verts,
            tri_v,
        )
        hit_b = np.asarray(tri_b) >= 0
        hit_t = np.asarray(tri_t) >= 0
        np.testing.assert_array_equal(hit_b, hit_t, err_msg=name)
        np.testing.assert_allclose(
            np.asarray(t_t)[hit_b], np.asarray(t_b)[hit_b], rtol=1e-5, err_msg=name
        )
        # Same triangle unless two tris tie in t (possible on shared edges).
        same = np.asarray(tri_t) == np.asarray(tri_b)
        close_t = np.isclose(np.asarray(t_t), np.asarray(t_b), rtol=1e-5)
        assert (same | close_t)[hit_b].all(), name


def test_anyhit_matches_brute_force():
    for name, scene in _scenes():
        bvh = build_bvh(scene.vertices, scene.tri_v, max_leaf=4)
        scene_r = reorder_scene(scene, bvh)
        o, d = _random_rays(scene, 256, seed=11)
        t_max = np.full(o.shape[0], 4.0, np.float32)
        verts = jnp.asarray(scene_r.vertices)
        tri_v = jnp.asarray(scene_r.tri_v)
        occ_b = isect.occluded_brute(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), verts, tri_v
        )
        occ_t = traverse_anyhit(
            jnp.asarray(o),
            jnp.asarray(d),
            jnp.asarray(t_max),
            jnp.ones(o.shape[0], bool),
            jnp.asarray(bvh.node_bounds),
            jnp.asarray(bvh.node_meta),
            verts,
            tri_v,
        )
        np.testing.assert_array_equal(np.asarray(occ_b), np.asarray(occ_t), err_msg=name)


def test_inactive_lanes_miss():
    scene, _ = cornell_box()
    bvh = build_bvh(scene.vertices, scene.tri_v)
    scene_r = reorder_scene(scene, bvh)
    o, d = _random_rays(scene, 64, seed=5)
    active = jnp.zeros(64, bool)
    t, tri, _, _ = traverse_closest(
        jnp.asarray(o), jnp.asarray(d), active,
        jnp.asarray(bvh.node_bounds), jnp.asarray(bvh.node_meta),
        jnp.asarray(scene_r.vertices), jnp.asarray(scene_r.tri_v),
    )
    assert (np.asarray(tri) == -1).all()
