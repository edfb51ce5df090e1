"""The ray-query layer: implementation selection (ops/traversal.py), the
CUDA kernel's wrapper and node packing (ops/traverse_cuda.py), and the
dispatch contract every accelerator meets (inactive lanes, partial masks,
ray counts that are not a multiple of the kernel's block).

The `gpu`-marked tests run the compiled kernel against the XLA references
on the card (CAITLYN_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu);
chip_smoke.py runs the same checks at full widths."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from caitlyn.accel.bvh import build_bvh
from caitlyn.core.types import RenderOptions
from caitlyn.io.builtin_scenes import (
    builtin_camera,
    cornell_box,
    displaced_grid,
    random_triangle_soup,
)
from caitlyn.ops import intersect as isect
from caitlyn.ops import traversal, traverse_cuda
from caitlyn.scene import required_stack, scene_families, upload_scene
from caitlyn.utils import parity


@pytest.mark.parametrize(
    "platform,accel,expected",
    [
        ("cpu", "auto", "xla_bvh"),
        ("gpu", "auto", "cuda_bvh"),
        ("cpu", "bvh2", "xla_bvh"),
        ("gpu", "bvh2", "cuda_bvh"),
        ("cpu", "sbvh", "xla_bvh"),
        ("gpu", "sbvh", "cuda_bvh"),
        ("cpu", "cwbvh", "xla_cwbvh"),
        ("gpu", "cwbvh", "xla_cwbvh"),
        ("cpu", "brute", "dense"),
        ("gpu", "brute", "dense"),
    ],
)
def test_select(platform, accel, expected):
    assert traversal.select(platform, accel) == expected


@pytest.mark.parametrize("tris", [1, 36, 2002, 1_000_000])
def test_auto_is_the_binary_bvh_at_every_size(tris):
    """`auto` resolves to the kernel's structure whatever the triangle
    count: the kernel beat the dense sweep at every size measured."""
    scene = random_triangle_soup(min(tris, 2000), seed=2)[0]
    assert traversal.select("gpu", "auto") == "cuda_bvh"
    assert traversal.AUTO_ACCEL == "bvh2"
    ds = upload_scene(scene, accel=traversal.AUTO_ACCEL)
    assert ds.bvh_nodes.shape == (ds.node_meta.shape[0], 16)


@pytest.mark.parametrize("platform,accel", [("rocm", "bvh2"), ("cpu", "quad")])
def test_select_refuses_unknown(platform, accel):
    with pytest.raises(ValueError):
        traversal.select(platform, accel)


def _tiny_query_args():
    scene, _ = cornell_box()
    bvh = build_bvh(scene.vertices, scene.tri_v)
    nodes = jnp.asarray(traverse_cuda.pack_nodes(bvh.node_bounds, bvh.node_meta))
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.ones((4, 3), jnp.float32)
    return o, d, jnp.ones(4, bool), nodes, jnp.asarray(scene.vertices), jnp.asarray(scene.tri_v)


@pytest.mark.parametrize("query", ["closest", "anyhit"])
def test_cuda_wrapper_raises_off_gpu(query):
    """The kernel wrapper refuses a non-GPU backend instead of falling back."""
    if jax.default_backend() == "gpu":
        pytest.skip("checks the refusal on a non-GPU backend")
    o, d, act, nodes, verts, tri_v = _tiny_query_args()
    with pytest.raises(RuntimeError, match="GPU"):
        if query == "closest":
            traverse_cuda.closest(o, d, act, nodes, verts, tri_v, 32)
        else:
            traverse_cuda.anyhit(o, d, jnp.ones(4), act, nodes, verts, tri_v, 32)


def _scene(name):
    if name == "cornell":
        return cornell_box()[0]
    if name == "soup":
        return random_triangle_soup(2000, seed=1)[0]
    return displaced_grid(resolution=24)[0]


@pytest.mark.parametrize("name", ["cornell", "soup", "grid"])
def test_pack_nodes_round_trip(name):
    """Kernel node records hold exactly the FlatBVH: every node's meta, and
    for each inner node its two children's boxes."""
    scene = _scene(name)
    bvh = build_bvh(scene.vertices, scene.tri_v, max_leaf=4)
    packed = traverse_cuda.pack_nodes(bvh.node_bounds, bvh.node_meta)
    assert packed.shape == (bvh.num_nodes, 16) and packed.dtype == np.float32
    meta = np.ascontiguousarray(packed[:, 12:14]).view(np.int32)
    np.testing.assert_array_equal(meta, bvh.node_meta)
    inner = bvh.node_meta[:, 1] == 0
    left = bvh.node_meta[inner, 0]
    bounds = np.full_like(bvh.node_bounds, np.nan)
    bounds[left] = packed[inner, 0:6]
    bounds[left + 1] = packed[inner, 6:12]
    # every node but the root is some inner node's child
    np.testing.assert_array_equal(bounds[1:], bvh.node_bounds[1:])
    assert not packed[~inner, :12].any()
    assert not packed[:, 14:].any()


def _contract_rays(scene, n, seed):
    verts, tri_v = jnp.asarray(scene.vertices), jnp.asarray(scene.tri_v)
    o, d = parity.parity_rays(
        verts, tri_v, builtin_camera("grid"), 12, 12,
        lambda o, d: isect.intersect_brute(o, d, verts, tri_v), seed,
    )
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, o.shape[0], n)
    return jnp.asarray(o[pick]), jnp.asarray(d[pick])


@pytest.mark.parametrize("accel", ["bvh2", "sbvh", "cwbvh"])
@pytest.mark.parametrize("case", ["inactive", "partial", "n200"])
def test_dispatch_contract(accel, case):
    """Through ops/traversal: inactive lanes miss, a partial mask leaves the
    active lanes' hits unchanged, and N = 200 (not a multiple of the
    kernel's 128-ray block) matches the dense sweep."""
    scene = displaced_grid(resolution=16, seed=4)[0]
    ds = upload_scene(scene, accel=accel)
    opts = RenderOptions(accel=accel, max_stack=required_stack(ds))
    n = 200 if case == "n200" else 256
    o, d = _contract_rays(scene, n, seed=5)
    full = jnp.ones(n, bool)
    t_max = jnp.full(n, 4.0, jnp.float32)
    if case == "inactive":
        none = jnp.zeros(n, bool)
        t, tri, _, _ = traversal.closest(ds, o, d, none, opts)
        assert (np.asarray(tri) == -1).all()
        assert (np.asarray(t) >= 1e8).all()
        assert not np.asarray(traversal.anyhit(ds, o, d, t_max, none, opts)).any()
        return
    if case == "partial":
        act = jnp.asarray(np.arange(n) % 3 != 0)
        _, tri_a, _, _ = traversal.closest(ds, o, d, act, opts)
        _, tri_f, _, _ = traversal.closest(ds, o, d, full, opts)
        a = np.asarray(act)
        np.testing.assert_array_equal(np.asarray(tri_a)[a], np.asarray(tri_f)[a])
        assert (np.asarray(tri_a)[~a] == -1).all()
        occ_a = np.asarray(traversal.anyhit(ds, o, d, t_max, act, opts))
        occ_f = np.asarray(traversal.anyhit(ds, o, d, t_max, full, opts))
        np.testing.assert_array_equal(occ_a[a], occ_f[a])
        assert not occ_a[~a].any()
        return
    sc = ds.scene
    ref = isect.intersect_brute(o, d, sc.vertices, sc.tri_v)
    got = traversal.closest(ds, o, d, full, opts)
    rep = parity.compare_closest(ref, got, o, d, sc.vertices, sc.tri_v)
    assert rep["hits"] > n // 4, rep
    assert parity.closest_ok(rep), rep
    occ_ref = isect.occluded_brute(o, d, t_max, sc.vertices, sc.tri_v)
    occ = traversal.anyhit(ds, o, d, t_max, full, opts)
    assert parity.anyhit_ok(parity.compare_anyhit(occ_ref, occ))


def test_compare_closest_counts_ties_and_mismatches():
    """The parity rule itself: a swap between two coplanar-at-t triangles
    is a tie, a hit/miss disagreement is not."""
    scene = _scene("cornell")
    verts, tri_v = np.asarray(scene.vertices), np.asarray(scene.tri_v)
    # two rays into the back wall quad's shared diagonal region
    o = np.array([[2.0, 2.0, 10.0], [2.0, 2.0, 10.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    ref = isect.intersect_brute(jnp.asarray(o), jnp.asarray(d), verts, tri_v)
    t_r, tri_r = np.asarray(ref[0]), np.asarray(ref[1])
    same_plane = [
        k for k in range(len(tri_v))
        if k != tri_r[0] and np.allclose(verts[tri_v[k, :3], 2], verts[tri_v[tri_r[0], :3], 2])
    ]
    got_t = t_r.copy()
    got_tri = np.array([same_plane[0], -1], np.int32)  # a tie, then a miss
    rep = parity.compare_closest((t_r, tri_r), (got_t, got_tri), o, d, verts, tri_v)
    assert rep["tri_mismatch"] == 2 and rep["ties"] == 1 and rep["non_tie"] == 1
    assert not parity.closest_ok(rep)


# ---------------------------------------------------------------------------
# On the card: the compiled kernel against the XLA references.
# ---------------------------------------------------------------------------


def _kernel_vs_references(scene, width, brute_rays):
    ds = upload_scene(scene, accel="bvh2")
    stack = required_stack(ds)
    sc = ds.scene
    from caitlyn.ops.traverse_xla import traverse_anyhit, traverse_closest

    def ref_closest(o, d):
        return traverse_closest(o, d, jnp.ones(o.shape[0], bool), ds.node_bounds,
                                ds.node_meta, sc.vertices, sc.tri_v, max_stack=stack)

    cam = builtin_camera("cornell" if scene.num_triangles < 100 else "grid")
    o, d = parity.parity_rays(sc.vertices, sc.tri_v, cam, width, width, ref_closest, 3)
    o, d = jnp.asarray(o), jnp.asarray(d)
    act = jnp.ones(o.shape[0], bool)
    ref = ref_closest(o, d)
    got = traverse_cuda.closest(o, d, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)
    rep = parity.compare_closest(ref, got, o, d, sc.vertices, sc.tri_v)
    assert parity.closest_ok(rep), rep
    b = slice(0, brute_rays)
    ref_b = isect.intersect_brute(o[b], d[b], sc.vertices, sc.tri_v)
    got_b = tuple(x[b] for x in got)
    rep_b = parity.compare_closest(ref_b, got_b, o[b], d[b], sc.vertices, sc.tri_v)
    assert parity.closest_ok(rep_b), rep_b
    t_max = jnp.where(got[1] >= 0, got[0] * 0.999, 50.0)
    occ_ref = traverse_anyhit(o, d, t_max, act, ds.node_bounds, ds.node_meta,
                              sc.vertices, sc.tri_v, max_stack=stack)
    occ = traverse_cuda.anyhit(o, d, t_max, act, ds.bvh_nodes, sc.vertices, sc.tri_v, stack)
    assert parity.anyhit_ok(parity.compare_anyhit(occ_ref, occ))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "soup", "grid"])
def test_cuda_kernel_matches_references(name):
    # 2·256² rays, so the tie allowance (1e-4 of the rays) is 13 rays
    _kernel_vs_references(_scene(name), 256, 2048)


@pytest.mark.gpu
def test_cuda_kernel_under_scan_grad_and_shard_map():
    """The kernel inside lax.scan (progressive.render_steps), under
    jax.grad of a render, and under shard_map over the local devices."""
    from caitlyn.grad.inverse import make_loss
    from caitlyn.parallel.mesh import make_mesh
    from caitlyn.parallel.render import init_sharded_state, sharded_render_step
    from caitlyn.render import progressive, sampling
    from caitlyn.render.integrator import render_sample

    scene = _scene("grid")
    ds = upload_scene(scene, accel="bvh2")
    cam = builtin_camera("grid")
    w = h = 32
    opts = RenderOptions(width=w, height=h, max_depth=2, accel="bvh2",
                         families=scene_families(scene),
                         max_stack=required_stack(ds))
    st = progressive.render_steps(ds, cam, progressive.init_state(w, h), w, h, opts, 2)
    assert np.isfinite(np.asarray(st.accum)).all() and float(st.accum.sum()) > 0
    key = jax.random.PRNGKey(0)
    target = render_sample(ds, cam, sampling.draw_uniforms(key, w * h, 2), w, h, opts)
    loss, g = jax.value_and_grad(make_loss(ds, cam, target * 0.5, w, h, opts))(
        {"albedo": ds.scene.materials.albedo}, key
    )
    assert np.isfinite(float(loss)) and np.isfinite(np.asarray(g["albedo"])).all()
    mesh = make_mesh(jax.devices(), shape=(len(jax.devices()), 1))
    sh = sharded_render_step(ds, cam, init_sharded_state(mesh, w, h), mesh, w, h, opts)
    one = progressive.render_step(ds, cam, progressive.init_state(w, h), w, h, opts)
    np.testing.assert_array_equal(np.asarray(sh.accum)[: w * h], np.asarray(one.accum))
