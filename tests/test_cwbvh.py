"""CWBVH: format invariants, quantization conservativeness, traversal
equivalence vs brute force, end-to-end parity."""

import pytest
import numpy as np
import jax.numpy as jnp

from caitlyn.accel.bvh import build_bvh, reorder_scene
from caitlyn.accel.cwbvh import build_cwbvh, MAX_LEAF_TRIS
from caitlyn.io.builtin_scenes import cornell_box, random_triangle_soup
from caitlyn.ops import intersect as isect
from caitlyn.ops.traverse_cwbvh import cwbvh_anyhit, cwbvh_closest


def _build(scene):
    bvh = build_bvh(scene.vertices, scene.tri_v, max_leaf=3)
    sr = reorder_scene(scene, bvh)
    cw = build_cwbvh(bvh, np.asarray(sr.vertices), np.asarray(sr.tri_v))
    tv = np.asarray(sr.tri_v)[cw.tri_order]
    verts = np.asarray(sr.vertices)
    p0 = verts[tv[:, 0]]
    packed = np.concatenate(
        [p0, verts[tv[:, 1]] - p0, verts[tv[:, 2]] - p0], axis=1
    ).astype(np.float32)
    # map cwbvh slot -> original scene tri id (tri_order composes the two
    # reorders; sr is already bvh-ordered so compose with bvh.tri_order)
    orig_ids = bvh.tri_order[cw.tri_order]
    return cw, packed, tv, orig_ids


def _scenes():
    return [("cornell", cornell_box()[0]), ("soup", random_triangle_soup(800, seed=6)[0])]


def test_format_invariants():
    for name, scene in _scenes():
        cw, packed, tv, orig = _build(scene)
        t = scene.num_triangles
        # every triangle present exactly once
        assert sorted(orig.tolist()) == list(range(t)), name
        nodes = cw.nodes
        assert nodes.dtype == np.uint32 and nodes.shape[1] == 20
        # decode and check per-node: meta bytes structure + quantized boxes
        # conservatively contain leaf-child triangles.
        for ni in range(nodes.shape[0]):
            w = nodes[ni]
            p = np.frombuffer(np.asarray(w[0:3]).tobytes(), np.float32)
            e = [(int(w[3]) >> (8 * k)) & 0xFF for k in range(3)]
            imask = (int(w[3]) >> 24) & 0xFF
            scale = np.array([np.exp2(ee - 127) for ee in e])
            tri_base = int(w[5])
            metas = [(int(w[6 + (s // 4)]) >> (8 * (s % 4))) & 0xFF for s in range(8)]
            for s, m in enumerate(metas):
                if m == 0:
                    assert not (imask >> s) & 1, name
                    continue
                is_inner = (m & 0b11000) == 0b11000
                if is_inner:
                    assert (imask >> s) & 1, name
                    assert (m & 0x1F) == 24 + s, name
                else:
                    cnt = bin(m >> 5).count("1")
                    assert 1 <= cnt <= MAX_LEAF_TRIS, name
                    off = m & 0x1F
                    # quantized box contains the child triangles
                    qlo = np.array([
                        (int(w[{0: 8, 1: 12, 2: 16}[a] + (s // 4)]) >> (8 * (s % 4))) & 0xFF
                        for a in range(3)
                    ], np.float64)
                    qhi = np.array([
                        (int(w[{0: 10, 1: 14, 2: 18}[a] + (s // 4)]) >> (8 * (s % 4))) & 0xFF
                        for a in range(3)
                    ], np.float64)
                    lo = p + qlo * scale
                    hi = p + qhi * scale
                    for j in range(cnt):
                        tslot = tri_base + off + j
                        tri = tv[tslot]
                        verts_used = np.stack([
                            packed[tslot, 0:3],
                            packed[tslot, 0:3] + packed[tslot, 3:6],
                            packed[tslot, 0:3] + packed[tslot, 6:9],
                        ])
                        assert (verts_used >= lo - 1e-3).all(), name
                        assert (verts_used <= hi + 1e-3).all(), name


def _random_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo = scene.vertices.min(axis=0) - 1.0
    hi = scene.vertices.max(axis=0) + 1.0
    o = (rng.random((n, 3)).astype(np.float32)) * (hi - lo) + lo
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_cwbvh_matches_brute():
    for name, scene in _scenes():
        cw, packed, tv, orig = _build(scene)
        o, d = _random_rays(scene, 384, seed=17)
        t_b, tri_b, _, _ = isect.intersect_brute(
            jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(scene.vertices), jnp.asarray(scene.tri_v),
        )
        t_c, tri_c, u_c, v_c = cwbvh_closest(
            jnp.asarray(o), jnp.asarray(d), jnp.ones(o.shape[0], bool),
            jnp.asarray(cw.nodes), jnp.asarray(packed),
        )
        hit_b = np.asarray(tri_b) >= 0
        hit_c = np.asarray(tri_c) >= 0
        np.testing.assert_array_equal(hit_b, hit_c, err_msg=name)
        np.testing.assert_allclose(
            np.asarray(t_c)[hit_b], np.asarray(t_b)[hit_b], rtol=1e-5, err_msg=name
        )


def test_cwbvh_anyhit_matches_brute():
    for name, scene in _scenes():
        cw, packed, tv, orig = _build(scene)
        o, d = _random_rays(scene, 384, seed=19)
        t_max = np.full(o.shape[0], 3.0, np.float32)
        occ_b = isect.occluded_brute(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.asarray(scene.vertices), jnp.asarray(scene.tri_v),
        )
        occ_c = cwbvh_anyhit(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.ones(o.shape[0], bool),
            jnp.asarray(cw.nodes), jnp.asarray(packed),
        )
        np.testing.assert_array_equal(np.asarray(occ_b), np.asarray(occ_c), err_msg=name)


@pytest.mark.slow
def test_cwbvh_end_to_end_parity(cornell):
    import jax
    from caitlyn.core.types import RenderOptions
    from caitlyn.cpu_reference import integrator as oracle
    from caitlyn.render import sampling
    from caitlyn.render.integrator import render_sample
    from caitlyn.scene import upload_scene

    scene, camera = cornell
    ds = upload_scene(scene, accel="cwbvh")
    w = h = 24
    options = RenderOptions(width=w, height=h, max_depth=2, accel="cwbvh")
    uniforms = np.asarray(sampling.draw_uniforms(jax.random.PRNGKey(9), w * h, 2))
    img_o = oracle.render(scene, camera, w, h, uniforms, max_depth=2)
    img_d = np.asarray(
        render_sample(ds, camera, jnp.asarray(uniforms), w, h, options)
    ).reshape(h, w, 3)
    diff = np.abs(img_d - img_o)
    bad = (diff > 2e-3 + 0.05 * np.abs(img_o)).any(axis=-1)
    assert bad.mean() < 0.01, bad.mean()
