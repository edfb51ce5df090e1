"""Checkpoint / resume for render and optimization state.

The reference has no persistence: its progressive state is the accumulate
FBO + frame counter, lost on exit (`/root/reference/Caitlyn/Scene.h:
1160-1177`).  Here both states are explicit pytrees, serialized with
numpy's npz (dependency-free, works on any host), so a preempted
multi-hour render or optimization resumes exactly — same RNG key, same
sample sequence (SURVEY.md §5 checkpoint plan)."""

from __future__ import annotations

import os
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from caitlyn.render.progressive import RenderState


def save_render_state(path: str, state: RenderState) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp,
        accum=np.asarray(state.accum),
        frame_count=np.asarray(state.frame_count),
        base_key=np.asarray(jax.random.key_data(state.base_key))
        if jnp.issubdtype(state.base_key.dtype, jax.dtypes.prng_key)
        else np.asarray(state.base_key),
    )
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_render_state(path: str) -> RenderState:
    z = np.load(path)
    key = jnp.asarray(z["base_key"], jnp.uint32)
    return RenderState(
        accum=jnp.asarray(z["accum"]),
        frame_count=jnp.asarray(z["frame_count"], jnp.int32),
        base_key=key,
    )


def save_params(path: str, params: Dict[str, Any], extra: Dict[str, Any] = None) -> None:
    """Save an optimization parameter pytree (+ optimizer scalars)."""
    flat = {f"p__{k}": np.asarray(v) for k, v in params.items()}
    if extra:
        flat.update({f"x__{k}": np.asarray(v) for k, v in extra.items()})
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_params(path: str):
    z = np.load(path)
    params = {k[3:]: jnp.asarray(z[k]) for k in z.files if k.startswith("p__")}
    extra = {k[3:]: jnp.asarray(z[k]) for k in z.files if k.startswith("x__")}
    return params, extra
