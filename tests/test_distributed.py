"""Distribution layer: init wiring, multihost mesh, assembly, scaling.

Runs on the 8-device virtual CPU mesh from conftest (SURVEY §4.5) — the
same code paths a real pod takes, with process_count == 1.
"""

import numpy as np
import jax
import pytest

from caitlyn.core.types import RenderOptions
from caitlyn.parallel.distributed import (
    assemble_image,
    init_distributed,
    make_multihost_mesh,
    scaling_report,
)
from caitlyn.parallel.render import (
    gather_image,
    init_sharded_state,
    sharded_render_step,
)
from caitlyn.scene import scene_families, upload_scene


@pytest.fixture(scope="module")
def setup(cornell):
    scene, camera = cornell
    ds = upload_scene(scene, accel="bvh2")
    options = RenderOptions(
        width=16, height=16, max_depth=2, families=scene_families(scene)
    )
    return ds, camera, options


def test_init_distributed_single_process_noop():
    """No coordinator, no launcher env → a no-op returning this process's
    identity (and NOT breaking the already-initialized local backend)."""
    idx, count = init_distributed()
    assert (idx, count) == (0, 1)
    # idempotent
    assert init_distributed() == (0, 1)


def test_make_multihost_mesh_shapes():
    mesh = make_multihost_mesh()
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.shape["dp"] * mesh.shape["sp"] == len(jax.devices())
    assert mesh.shape["sp"] == 2  # 8 virtual devices → sp=2 default
    mesh1 = make_multihost_mesh(sp=1)
    assert mesh1.shape["sp"] == 1
    with pytest.raises(ValueError):
        make_multihost_mesh(sp=3)  # does not divide 8


def test_assemble_image_matches_gather_image(setup):
    """Single-process assemble_image must equal the device-side
    gather_image resolve (both route through resolve_accum)."""
    ds, camera, options = setup
    mesh = make_multihost_mesh()
    sp = mesh.shape["sp"]
    w, h = options.width, options.height
    state = init_sharded_state(mesh, w, h, seed=0)
    state = sharded_render_step(ds, camera, state, mesh, w, h, options)
    img_a = assemble_image(state, mesh, w, h, options, sp)
    img_g = np.asarray(gather_image(state, w, h, options, sp))
    assert img_a.shape == (h, w, 3)
    np.testing.assert_array_equal(img_a, img_g)


def test_scaling_report_runs_and_counts_real_rays(setup):
    """The BASELINE ≥85% harness: sane structure, instrumented ray counts
    (not the w·h·depth proxy), positive throughputs.  Efficiency on the
    virtual CPU mesh is NOT asserted against the 85% target — 8 virtual
    devices share one physical CPU, so the number is only a wiring check
    here; the real measurement runs on pod hardware."""
    ds, camera, options = setup
    rep = scaling_report(ds, camera, options, options.width, options.height, spp=1)
    assert rep["devices"] == len(jax.devices())
    assert rep["rays_per_sec_per_chip_1"] > 0
    assert rep["rays_per_sec_per_chip_n"] > 0
    assert rep["scaling_efficiency"] > 0
    # instrumented count: strictly fewer rays than the optimistic
    # w*h*(closest+anyhit per depth) upper bound, and more than primaries
    n = options.width * options.height
    assert n <= rep["rays_per_sample"] < n * options.max_depth * 2


def test_cli_mesh_render_writes_png(setup, tmp_path):
    """`render --mesh auto` drives make_multihost_mesh +
    sharded_render_step + assemble_image end-to-end."""
    from caitlyn.cli import main
    from caitlyn.io.image import load_png

    out = tmp_path / "mesh.png"
    rc = main(
        [
            "render",
            "scenes/cornell.toml",
            "-o",
            str(out),
            "--mesh",
            "auto",
            "--spp",
            "4",
            "--width",
            "16",
            "--height",
            "16",
            "--depth",
            "2",
        ]
    )
    assert rc == 0
    img = load_png(str(out))
    assert img.shape == (16, 16, 3)
    assert img.max() > 0.05  # not a black frame


def test_tiled_sharded_render_bitwise_matches_untiled(setup):
    """Tile grid sharded across chips (SURVEY §2 parallelism table): a
    4x4-tile render over the (4, 2) mesh is BITWISE equal to the untiled
    single-device progressive render — pixels keep global RNG ids, so
    distribution layout never changes the image."""
    import jax.numpy as jnp

    from caitlyn.parallel.render import (
        gather_image_tiled,
        init_tiled_state,
        sharded_render_step_tiled,
        tile_pixel_order,
    )
    from caitlyn.render import progressive

    ds, camera, options = setup
    w = h = options.width
    # sp=1 for the BITWISE claim: the sp psum's cross-device reduction
    # order is unspecified, so sp>1 agrees only to reassociation ulps
    # (same caveat as the dryrun's determinism proof).
    mesh = make_multihost_mesh(sp=1)
    dp = mesh.shape["dp"]
    order, n_pad = tile_pixel_order(w, h, 4, 4, dp)
    accum, order_dev = init_tiled_state(mesh, order)
    accum = sharded_render_step_tiled(
        ds, camera, accum, order_dev, jnp.int32(0),
        jax.random.PRNGKey(7), mesh, w, h, options,
    )
    img_tiled = np.asarray(
        gather_image_tiled(accum, order, jnp.int32(1), 1, w, h, options)
    )

    st = progressive.init_state(w, h, seed=7)
    st = progressive.render_step(ds, camera, st, w, h, options)
    img_ref = np.asarray(progressive.resolve(st, w, h, options))
    np.testing.assert_array_equal(img_tiled, img_ref)
