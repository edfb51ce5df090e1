"""Inverse rendering: optimize scene parameters against a target image.

The differentiable pass promised by the BASELINE north star: per-pixel
radiance differentiates w.r.t. camera, geometry (vertices), and BSDF
parameters through the detached-traversal estimator (hit ids are integers
from traversal; every shading quantity — uvt via `refine_hit`, normals,
BSDF eval, light terms — is recomputed differentiably; see
render/integrator.py).  Known estimator limitations, documented:
visibility/silhouette gradients are zero (no edge sampling in v1), and
discrete sampling decisions (light pick, lobe pick, RR) are detached.

`OptimizableParams` selects which leaves get gradients; everything else is
closed over.  The optimizer is plain Adam on the pytree (optax-free to
keep the dependency surface minimal, but optax works on the same loss_fn).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp

from caitlyn.core.types import Camera, RenderOptions
from caitlyn.render import sampling
from caitlyn.render.integrator import render_sample
from caitlyn.scene import DeviceScene

Params = Dict[str, Any]


def apply_params(ds: DeviceScene, camera: Camera, params: Params):
    """Overlay optimizable parameters onto the scene/camera pytrees.

    Supported keys: albedo (M,4) | disney (M,4) | emission (M,4) |
    vertices (V,3) | cam_position (3,) | cam_fov ()."""
    sc = ds.scene
    mats = sc.materials
    if "albedo" in params:
        mats = mats._replace(albedo=params["albedo"])
    if "disney" in params:
        mats = mats._replace(disney=params["disney"])
    if "emission" in params:
        mats = mats._replace(emission=params["emission"])
    sc = sc._replace(materials=mats)
    if "vertices" in params:
        sc = sc._replace(vertices=params["vertices"])
    ds = ds._replace(scene=sc)
    if ds.shade_tab is not None:
        # The fused shading table caches vertices/normals/material rows;
        # rebuild it from the overlaid scene so gradients flow through it
        # to the optimizable leaves.
        from caitlyn.render.integrator import _build_shade_table

        ds = ds._replace(shade_tab=_build_shade_table(sc))
    if "cam_position" in params:
        camera = camera._replace(position=params["cam_position"])
    if "cam_fov" in params:
        camera = camera._replace(fov=params["cam_fov"])
    return ds, camera


def project_params(params: Params) -> Params:
    """Project optimizable parameters back to their physical domains after
    a gradient step: albedo/emission RGB >= 0 (albedo <= 1), Disney
    parameters in [0, 1].  Unconstrained steps walk outside the domain
    (Adam on MC-noise gradients random-walks), where the BSDF produces
    NaNs (e.g. sqrt of a negative tint) that then poison Adam's moments
    permanently.  Material column 3 is the type/flag word — never
    touched."""
    out = dict(params)
    if "albedo" in out:
        a = out["albedo"]
        out["albedo"] = a.at[:, :3].set(jnp.clip(a[:, :3], 0.0, 1.0))
    if "disney" in out:
        out["disney"] = jnp.clip(out["disney"], 0.0, 1.0)
    if "emission" in out:
        e = out["emission"]
        out["emission"] = e.at[:, :3].set(jnp.maximum(e[:, :3], 0.0))
    return out


def make_loss(
    ds: DeviceScene,
    camera: Camera,
    target,  # (H*W, 3) radiance
    width: int,
    height: int,
    options: RenderOptions,
):
    """Loss(params, key) = mean squared error of a 1-spp render vs target."""

    def loss_fn(params: Params, key):
        ds2, cam2 = apply_params(ds, camera, params)
        uniforms = sampling.draw_uniforms(key, width * height, options.max_depth)
        img = render_sample(ds2, cam2, uniforms, width, height, options)
        return jnp.mean((img - target) ** 2)

    return loss_fn


class AdamState(NamedTuple):
    step: jax.Array
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    z = jax.tree_util.tree_map(jnp.zeros_like, params)
    return AdamState(step=jnp.int32(0), mu=z, nu=jax.tree_util.tree_map(jnp.zeros_like, params))


def adam_update(grads: Params, state: AdamState, params: Params, lr=1e-2, b1=0.9, b2=0.999, eps=1e-8):
    step = state.step + 1
    mu = jax.tree_util.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = jax.tree_util.tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    t = step.astype(jnp.float32)
    mhat = jax.tree_util.tree_map(lambda m: m / (1 - b1**t), mu)
    vhat = jax.tree_util.tree_map(lambda v: v / (1 - b2**t), nu)
    new_params = jax.tree_util.tree_map(
        lambda p, m, v: p - lr * m / (jnp.sqrt(v) + eps), params, mhat, vhat
    )
    return new_params, AdamState(step=step, mu=mu, nu=nu)


def optimize(
    ds: DeviceScene,
    camera: Camera,
    target,
    params: Params,
    width: int,
    height: int,
    options: RenderOptions,
    steps: int = 100,
    lr: float = 1e-2,
    seed: int = 0,
    callback=None,
):
    """Adam-optimize `params` to match `target`.  Returns (params, losses)."""
    loss_fn = make_loss(ds, camera, target, width, height, options)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    opt_state = adam_init(params)
    key = jax.random.PRNGKey(seed)
    losses = []
    for i in range(steps):
        k = jax.random.fold_in(key, i)
        loss, grads = grad_fn(params, k)
        params, opt_state = adam_update(grads, opt_state, params, lr=lr)
        params = project_params(params)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1], params)
    return params, losses
