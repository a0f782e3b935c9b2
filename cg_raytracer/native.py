"""ctypes bindings to the native C++ runtime components.

The reference's build-time hot paths are C++ (BVH construction,
``src/bounding_volume_hierarchy.cpp:42-464``; mesh import via assimp).  The
framework keeps the device compute path in JAX and implements the host runtime
natively too: ``native/bvh_builder.cpp`` is compiled to
``libcgrt.so`` on first use (g++ via the checked-in Makefile) and loaded here with
ctypes.  Every native entry point has a pure-Python fallback, so the framework works
without a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcgrt.so")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_NATIVE_DIR, "bvh_builder.cpp"))
            ):
                subprocess.run(
                    ["make", "-s", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB_PATH)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.cgrt_build_bvh.restype = ctypes.c_int
            lib.cgrt_build_bvh.argtypes = [
                f32p, f32p, f32p, ctypes.c_int,  # tri_lo, tri_hi, centroids, num_tris
                ctypes.c_int, ctypes.c_int,  # max_depth, max_leaf
                f32p, f32p, i32p, i32p, i32p, i32p, i32p,  # node arrays + order
            ]
            lib.cgrt_load_obj.restype = ctypes.c_void_p
            lib.cgrt_load_obj.argtypes = [ctypes.c_char_p]
            lib.cgrt_obj_num_meshes.restype = ctypes.c_int
            lib.cgrt_obj_num_meshes.argtypes = [ctypes.c_void_p]
            lib.cgrt_obj_mesh_sizes.restype = ctypes.c_int
            lib.cgrt_obj_mesh_sizes.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.cgrt_obj_mesh_data.restype = ctypes.c_int
            lib.cgrt_obj_mesh_data.argtypes = [
                ctypes.c_void_p, ctypes.c_int, f32p, f32p, i32p, f32p,
            ]
            lib.cgrt_obj_free.restype = None
            lib.cgrt_obj_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def native_build_bvh(tri_lo, tri_hi, centroids, max_depth: int, max_leaf: int):
    """Native BVH build; returns the same tuple as ops.bvh._build_numpy or raises."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    num_tris = int(tri_lo.shape[0])
    max_nodes = 2 * num_tris + 1
    node_lo = np.zeros((max_nodes, 3), np.float32)
    node_hi = np.zeros((max_nodes, 3), np.float32)
    left = np.full((max_nodes,), -1, np.int32)
    right = np.full((max_nodes,), -1, np.int32)
    first = np.zeros((max_nodes,), np.int32)
    count = np.zeros((max_nodes,), np.int32)
    order = np.arange(num_tris, dtype=np.int32)
    n = lib.cgrt_build_bvh(
        np.ascontiguousarray(tri_lo, np.float32),
        np.ascontiguousarray(tri_hi, np.float32),
        np.ascontiguousarray(centroids, np.float32),
        num_tris, int(max_depth), int(max_leaf),
        node_lo, node_hi, left, right, first, count, order,
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (rc={n})")
    return (node_lo[:n], node_hi[:n], left[:n], right[:n], first[:n], count[:n], order)


def native_load_obj(path: str):
    """Native OBJ/MTL parse (native/obj_loader.cpp); returns the same list of
    {vertices, normals, triangles, material} dicts as scene.loader's pure-Python
    parser, or raises if the native library (or the file) is unavailable."""
    import ctypes as ct

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    handle = lib.cgrt_load_obj(os.fsencode(path))
    if not handle:
        raise RuntimeError(f"native OBJ load failed for {path}")
    try:
        meshes = []
        for i in range(lib.cgrt_obj_num_meshes(handle)):
            nv = ct.c_int32()
            nt = ct.c_int32()
            if lib.cgrt_obj_mesh_sizes(handle, i, ct.byref(nv), ct.byref(nt)) != 0:
                raise RuntimeError("native OBJ mesh query failed")
            vertices = np.zeros((nv.value, 3), np.float32)
            normals = np.zeros((nv.value, 3), np.float32)
            triangles = np.zeros((nt.value, 3), np.int32)
            material = np.zeros((8,), np.float32)
            if lib.cgrt_obj_mesh_data(handle, i, vertices, normals, triangles,
                                      material) != 0:
                raise RuntimeError("native OBJ mesh read failed")
            meshes.append({
                "vertices": vertices,
                "normals": normals,
                "triangles": triangles,
                "material": {
                    "kd": tuple(float(x) for x in material[0:3]),
                    "ks": tuple(float(x) for x in material[3:6]),
                    "shininess": float(material[6]),
                    "transparency": float(material[7]),
                },
            })
        return meshes
    finally:
        lib.cgrt_obj_free(handle)
