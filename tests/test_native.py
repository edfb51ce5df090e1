"""Native C++ builder ≡ NumPy builder: same invariants, same traversal
results, and a build-speed sanity check."""

import time

import numpy as np
import jax.numpy as jnp
import pytest

from caitlyn.accel.bvh import FlatBVH, build_bvh, reorder_scene
from caitlyn.accel.native import native_available
from caitlyn.io.builtin_scenes import displaced_grid, random_triangle_soup
from caitlyn.ops import intersect as isect
from caitlyn.ops.traverse_xla import traverse_closest


@pytest.fixture(autouse=True)
def _native():
    if not native_available():
        pytest.skip("native toolchain unavailable")


def test_native_invariants_and_equivalence():
    scene, _ = random_triangle_soup(5000, seed=30)
    t = scene.num_triangles
    bvh_n = build_bvh(scene.vertices, scene.tri_v, max_leaf=4, use_native=True)
    bvh_p = build_bvh(scene.vertices, scene.tri_v, max_leaf=4, use_native=False)

    for bvh, name in ((bvh_n, "native"), (bvh_p, "numpy")):
        leaf = bvh.is_leaf()
        starts = bvh.node_meta[leaf, 0]
        counts = bvh.node_meta[leaf, 1]
        covered = np.zeros(t, np.int32)
        for s, c in zip(starts, counts):
            covered[s : s + c] += 1
        assert (covered == 1).all(), name
        assert sorted(bvh.tri_order.tolist()) == list(range(t)), name
        inner = ~leaf
        left = bvh.node_meta[inner, 0]
        pb = bvh.node_bounds[inner]
        for child in (left, left + 1):
            cb = bvh.node_bounds[child]
            assert (cb[:, :3] >= pb[:, :3] - 1e-4).all(), name
            assert (cb[:, 3:] <= pb[:, 3:] + 1e-4).all(), name

    # Traversal over both trees gives identical closest hits.
    rng = np.random.default_rng(31)
    n = 256
    lo = scene.vertices.min(axis=0) - 1
    hi = scene.vertices.max(axis=0) + 1
    o = (rng.random((n, 3)).astype(np.float32)) * (hi - lo) + lo
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    results = []
    for bvh in (bvh_n, bvh_p):
        sr = reorder_scene(scene, bvh)
        t_t, tri_t, _, _ = traverse_closest(
            jnp.asarray(o), jnp.asarray(d), jnp.ones(n, bool),
            jnp.asarray(bvh.node_bounds), jnp.asarray(bvh.node_meta),
            jnp.asarray(sr.vertices), jnp.asarray(sr.tri_v),
        )
        results.append((np.asarray(t_t), np.asarray(tri_t)))
    np.testing.assert_array_equal(results[0][1] >= 0, results[1][1] >= 0)
    hit = results[0][1] >= 0
    np.testing.assert_allclose(results[0][0][hit], results[1][0][hit], rtol=1e-5)


@pytest.mark.slow
def test_native_speed():
    scene, _ = displaced_grid(resolution=160)  # ~50k tris
    t0 = time.perf_counter()
    build_bvh(scene.vertices, scene.tri_v, use_native=True)
    dt_native = time.perf_counter() - t0
    # ~50k tris should build well under a second natively.
    assert dt_native < 2.0, dt_native
