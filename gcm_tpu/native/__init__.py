"""Native (C++) runtime components, built on demand and driven via ctypes.

The reference's runtime around the solver is C++ (CGAL point location, VTK
writers — SURVEY.md §1); this package provides the equivalents for the
framework. Everything has a pure-Python fallback: ``available()``
reports whether the shared library could be built, and callers degrade
gracefully (scipy global point location, numpy transpose).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gcm_native.cpp")
_SO = os.path.join(_HERE, "libgcm_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", _SO, _SRC],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_SO)
        lib.walk_locate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,              # points, npts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # cells, neigh, ncells
            ctypes.c_void_p,                              # transform
            ctypes.c_void_p, ctypes.c_int64,              # queries, nq
            ctypes.c_void_p,                              # starts
            ctypes.c_int,                                 # dim
            ctypes.c_void_p, ctypes.c_void_p,             # out_cell, out_bary
        ]
        lib.transpose_f_order.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
        ]
        return lib
    except Exception:
        _build_failed = True
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def available() -> bool:
    return _get() is not None


def walk_locate(
    delaunay, queries: np.ndarray, starts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Visibility-walk point location with barycentric output.

    ``delaunay``: scipy.spatial.Delaunay; ``starts``: per-query starting
    cell (walks are O(1) when starts are incident to the query's node).
    Returns (cells [nq] int32 with -1 outside, bary [nq, dim+1] float64).
    """
    lib = _get()
    dim = delaunay.points.shape[1]
    queries = np.ascontiguousarray(queries, np.float64)
    nq = len(queries)
    if lib is None:
        cells = delaunay.find_simplex(queries).astype(np.int32)
        ok = cells >= 0
        cc = np.where(ok, cells, 0)
        T = delaunay.transform[cc]
        b = np.einsum("nij,nj->ni", T[:, :dim, :], queries - T[:, dim, :])
        bary = np.concatenate([b, 1.0 - b.sum(1, keepdims=True)], axis=1)
        bary[~ok] = 0.0
        return cells, bary

    points = np.ascontiguousarray(delaunay.points, np.float64)
    cells_arr = np.ascontiguousarray(delaunay.simplices, np.int32)
    neigh = np.ascontiguousarray(delaunay.neighbors, np.int32)
    transform = np.ascontiguousarray(delaunay.transform, np.float64)
    starts = np.ascontiguousarray(starts, np.int32)
    out_cell = np.empty(nq, np.int32)
    out_bary = np.empty((nq, dim + 1), np.float64)
    lib.walk_locate(
        points.ctypes.data, len(points),
        cells_arr.ctypes.data, neigh.ctypes.data, len(cells_arr),
        transform.ctypes.data,
        queries.ctypes.data, nq,
        starts.ctypes.data,
        dim,
        out_cell.ctypes.data, out_bary.ctypes.data,
    )
    return out_cell, out_bary


def transpose_f_order(a: np.ndarray) -> np.ndarray:
    """float32 C-order [n0, n1, n2] -> flat Fortran-order copy."""
    lib = _get()
    a = np.ascontiguousarray(a, np.float32)
    if lib is None or a.ndim != 3:
        return np.asfortranarray(a).ravel(order="F")
    out = np.empty(a.size, np.float32)
    lib.transpose_f_order(a.ctypes.data, *map(int, a.shape), out.ctypes.data)
    return out
