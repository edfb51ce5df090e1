"""ctypes loader for the native (C++) host builders.

Compiles `native/bvh_builder.cpp` on first use with g++ into
`native/build/` (git-ignored), exposing the same FlatBVH contract as the NumPy builders.  The
NumPy builders remain the reference implementation and the fallback when
no toolchain is available (set CAITLYN_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compile_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CAITLYN_NO_NATIVE"):
        return None
    src = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")
    so = os.path.join(_NATIVE_DIR, "build", "libbvh.so")
    try:
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)  # concurrent builders never load half a file
        lib = ctypes.CDLL(so)
        lib.build_bvh_sah.restype = ctypes.c_int
        lib.build_bvh_sah.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # bmin
            ctypes.POINTER(ctypes.c_float),  # bmax
            ctypes.POINTER(ctypes.c_float),  # cent
            ctypes.c_int,  # num_tris
            ctypes.c_int,  # max_leaf
            ctypes.POINTER(ctypes.c_float),  # node_bounds
            ctypes.POINTER(ctypes.c_int),  # node_meta
            ctypes.POINTER(ctypes.c_int),  # tri_order
            ctypes.c_int,  # cap
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _compile_and_load() is not None


def build_bvh_native(tri_bmin, tri_bmax, cent, max_leaf: int):
    """Run the C++ builder; returns (node_bounds, node_meta, tri_order)
    or None when the native library is unavailable."""
    lib = _compile_and_load()
    if lib is None:
        return None
    t = tri_bmin.shape[0]
    cap = 2 * t + 2
    bmin = np.ascontiguousarray(tri_bmin, np.float32)
    bmax = np.ascontiguousarray(tri_bmax, np.float32)
    cen = np.ascontiguousarray(cent, np.float32)
    node_bounds = np.empty((cap, 6), np.float32)
    node_meta = np.empty((cap, 2), np.int32)
    tri_order = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.build_bvh_sah(
        bmin.ctypes.data_as(fp),
        bmax.ctypes.data_as(fp),
        cen.ctypes.data_as(fp),
        t,
        max_leaf,
        node_bounds.ctypes.data_as(fp),
        node_meta.ctypes.data_as(ip),
        tri_order.ctypes.data_as(ip),
        cap,
    )
    if n < 0:
        return None
    return node_bounds[:n].copy(), node_meta[:n].copy(), tri_order
