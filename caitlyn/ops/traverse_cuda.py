"""Binary-BVH traversal on NVIDIA GPUs: the CUDA kernel in
`native/traverse.cu`, one thread per ray, called through `jax.ffi`.

The kernel reads the same `FlatBVH` that `bvh2` and `sbvh` build, repacked
at upload by `pack_nodes` into one 64-byte record per node (both children's
boxes beside the node's meta, so an inner node costs one record fetch).
Its results follow `ops/traverse_xla.py`, which stays as the reference and
as the CPU implementation (`ops/traversal.py` chooses between them).

The library is compiled from the repository's source with `nvcc` at first
use into `native/build/` (git-ignored), under a name keyed by the source and
the flags, so an edited source is never served by a stale binary:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -I $(python -c 'import jax.ffi; \\
         print(jax.ffi.include_dir())') -o native/build/libtraverse_<key>.so \\
         native/traverse.cu

The kernel has no interpret mode and no VJP: callers pass detached inputs
(`lax.stop_gradient`), so `jax.grad` of a render never differentiates it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
SOURCE = os.path.join(_NATIVE_DIR, "traverse.cu")
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No multiply-add contraction: the kernel rounds every operation as
    # written, in the order of the XLA reference it is checked against.
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# Largest stack the library is compiled for (native/traverse.cu
# with_capacity); deeper trees are refused at trace time.
MAX_STACK = 256
_CLOSEST = "caitlyn_bvh_closest"
_ANYHIT = "caitlyn_bvh_anyhit"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA BVH "
            "traversal cannot be built"
        )
    return found


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtraverse_{key.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is already built; returns its path.
    Raises RuntimeError with nvcc's output when compilation fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


@functools.cache
def load() -> str:
    """Build (if needed) and load the library and register its FFI targets
    for the CUDA platform, once per process.  Returns the library path."""
    path = build()
    lib = ctypes.cdll.LoadLibrary(path)
    jax.ffi.register_ffi_target(
        _CLOSEST, jax.ffi.pycapsule(lib.CaitlynBvhClosest), platform="CUDA"
    )
    jax.ffi.register_ffi_target(
        _ANYHIT, jax.ffi.pycapsule(lib.CaitlynBvhAnyHit), platform="CUDA"
    )
    return path


def pack_nodes(node_bounds, node_meta) -> np.ndarray:
    """FlatBVH → (Nn, 16) f32 kernel node records (host, at upload):
    [0:6] left child box, [6:12] right child box (inner nodes; zero for
    leaves), [12:14] the node's meta bit-cast to f32, [14:16] zero."""
    nb = np.asarray(node_bounds, np.float32)
    meta = np.ascontiguousarray(np.asarray(node_meta, np.int32))
    out = np.zeros((meta.shape[0], 16), np.float32)
    inner = meta[:, 1] == 0
    left = meta[inner, 0]
    out[inner, 0:6] = nb[left]
    out[inner, 6:12] = nb[left + 1]
    out[:, 12:14] = meta.view(np.float32)
    return out


def pack_triangles(verts, tri_v):
    """(T, 12) f32 rows v0, e1, e2, pad (three float4 loads per triangle).
    Traced, so vertex edits and gradients see the current geometry; XLA
    computes it once per jitted frame however many queries read it."""
    v0 = verts[tri_v[:, 0]]
    e1 = verts[tri_v[:, 1]] - v0
    e2 = verts[tri_v[:, 2]] - v0
    return jnp.concatenate([v0, e1, e2, jnp.zeros_like(v0)], axis=1)


def _check(max_stack: int) -> None:
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the CUDA BVH traversal runs only on a GPU backend "
            f"(this one is {jax.default_backend()!r}); ops/traversal.py "
            "selects ops/traverse_xla.py elsewhere"
        )
    if max_stack > MAX_STACK:
        raise ValueError(
            f"max_stack={max_stack} exceeds the compiled maximum {MAX_STACK}"
        )
    load()


# vmap_method="sequential": a batch of ray sets becomes a loop of kernel
# calls, which is correct whichever inputs carry the batch axis.
def closest(o, d, active, nodes, verts, tri_v, max_stack: int):
    """Closest hit: (t, tri, u, v), tri = -1 and t = 1e9 on a miss."""
    _check(max_stack)
    n = o.shape[0]
    if tri_v.shape[0] == 0:
        zero = jnp.zeros(n, jnp.float32)
        return jnp.full(n, 1e9, jnp.float32), jnp.full(n, -1, jnp.int32), zero, zero
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return jax.ffi.ffi_call(_CLOSEST, (f32, i32, f32, f32), vmap_method="sequential")(
        o.astype(jnp.float32), d.astype(jnp.float32), active.astype(jnp.int32),
        nodes, pack_triangles(verts, tri_v), max_stack=int(max_stack),
    )


def anyhit(o, d, t_max, active, nodes, verts, tri_v, max_stack: int):
    """Any hit in [0, t_max): (N,) bool."""
    _check(max_stack)
    n = o.shape[0]
    if tri_v.shape[0] == 0:
        return jnp.zeros(n, bool)
    occ = jax.ffi.ffi_call(
        _ANYHIT, jax.ShapeDtypeStruct((n,), jnp.int32), vmap_method="sequential"
    )(
        o.astype(jnp.float32), d.astype(jnp.float32),
        t_max.astype(jnp.float32), active.astype(jnp.int32), nodes,
        pack_triangles(verts, tri_v), max_stack=int(max_stack),
    )
    return occ > 0
