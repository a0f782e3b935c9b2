"""Per-ray BVH traversal on NVIDIA GPUs: ``native/bvh_traverse.cu`` through
``jax.ffi``.

The kernel answers the same closest-hit and any-hit queries as the jnp
traversal (``ops/bvh.py::traverse_closest``) over the same flattened ``BVH``,
one thread per ray, with the slab padding and Moller-Trumbore epsilons of the
jnp code, so the two agree up to tie-breaks on coincident hits.  The jnp
traversal stays the reference and the CPU path.

Host side kept here, all of it testable without a GPU:

- ``pack_nodes`` / ``pack_triangles``: the kernel's 16-byte-aligned records,
  built from the ``BVH`` arrays with jnp (so a refit tree repacks inside the
  jitted step; the pack is one fused elementwise pass per render call).
- ``unpack_nodes``: the inverse of ``pack_nodes`` (tests round-trip it).
- ``batched_oracle``: folds vmapped batch axes into the ray axis, so a vmap
  over lights or samples makes one kernel launch, not one per batch element.
- ``on_mesh``: shard_map over every axis of a ray-sharded mesh, so each
  device traverses only its rays (a custom call is otherwise replicated).

The shared library is compiled from the repository's source with ``nvcc`` at
first use into ``build/cuda/`` of the checkout (listed in .gitignore).  A
failed build raises; there is no fallback to the jnp traversal.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..scene.types import Scene
from .bvh import BVH, closest_with_spheres, occluded_with_spheres
from .intersect import Hit

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
_SOURCE = os.path.join(_REPO, "native", "bvh_traverse.cu")
_BUILD_DIR = os.path.join(_REPO, "build", "cuda")
_LIBRARY = os.path.join(_BUILD_DIR, "libcgrt_cuda.so")
_CLOSEST = "cgrt_bvh_closest"
_OCCLUDED = "cgrt_bvh_occluded"

_lock = threading.Lock()
_registered = False

NODE_WORDS = 8  # [lo.xyz, left|first] [hi.xyz, right|-count]
TRI_WORDS = 12  # [v0.xyz, prim] [e1.xyz, 0] [e2.xyz, 0]


def _bits(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.int32)


def pack_nodes(bvh: BVH):
    """[Nn, 8] int32 node records.  Internal nodes carry (left, right), leaves
    (first, -count): the sign of the last word tells them apart."""
    leaf = bvh.count > 0
    a = jnp.where(leaf, bvh.first, bvh.left).astype(jnp.int32)
    b = jnp.where(leaf, -bvh.count, bvh.right).astype(jnp.int32)
    return jnp.concatenate(
        [_bits(bvh.node_lo), a[:, None], _bits(bvh.node_hi), b[:, None]], axis=1)


def unpack_nodes(nodes):
    """Inverse of ``pack_nodes``: (node_lo, node_hi, left, right, first, count)
    as numpy arrays, with the ``BVH`` conventions (-1 children on leaves, zero
    first/count on internal nodes)."""
    nodes = np.asarray(nodes, np.int32)
    lo = nodes[:, 0:3].view(np.float32)
    hi = nodes[:, 4:7].view(np.float32)
    a, b = nodes[:, 3], nodes[:, 7]
    leaf = b < 0
    left = np.where(leaf, -1, a).astype(np.int32)
    right = np.where(leaf, -1, b).astype(np.int32)
    first = np.where(leaf, a, 0).astype(np.int32)
    count = np.where(leaf, -b, 0).astype(np.int32)
    return lo, hi, left, right, first, count


def pack_triangles(bvh: BVH):
    """[T, 12] int32 triangle records in BVH slot order: v0 with the original
    triangle id, then the two edges (the kernel's Moller-Trumbore operands,
    rounded exactly as the jnp code's ``v1 - v0`` and ``v2 - v0``)."""
    zero = jnp.zeros((bvh.tv0.shape[0], 1), jnp.int32)
    prim = bvh.tri_order.astype(jnp.int32)[:, None]
    return jnp.concatenate(
        [_bits(bvh.tv0), prim, _bits(bvh.tv1 - bvh.tv0), zero,
         _bits(bvh.tv2 - bvh.tv0), zero], axis=1)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "backend='cuda' needs nvcc (the CUDA toolkit) to build "
            f"{_SOURCE}; none found on PATH or under /usr/local/cuda")
    return path


def build_library() -> str:
    """Compile the kernel library if it is missing or older than its source;
    returns its path.  Raises with nvcc's output if the build fails."""
    if (os.path.exists(_LIBRARY)
            and os.path.getmtime(_LIBRARY) >= os.path.getmtime(_SOURCE)):
        return _LIBRARY
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {_SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, _LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIBRARY


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU."""
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            f"backend='cuda' runs the CUDA traversal kernel and needs an "
            f"NVIDIA GPU, but JAX's default backend is {platform!r}; use "
            f"backend='bvh' (jnp traversal) or 'auto'")


def _register() -> None:
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            _CLOSEST, jax.ffi.pycapsule(lib.CgrtBvhClosest), platform="CUDA")
        jax.ffi.register_ffi_target(
            _OCCLUDED, jax.ffi.pycapsule(lib.CgrtBvhOccluded), platform="CUDA")
        _registered = True


def _closest_call(nodes, tris, origins, dirs, t_max):
    n = t_max.shape[0]
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return jax.ffi.ffi_call(_CLOSEST, (f32, i32, f32, f32))(
        nodes, tris, origins, dirs, t_max)


def _occluded_call(nodes, tris, origins, dirs, t_max):
    n = t_max.shape[0]
    out = jax.ffi.ffi_call(_OCCLUDED, jax.ShapeDtypeStruct((n,), jnp.uint8))(
        nodes, tris, origins, dirs, t_max)
    return out != 0


def on_mesh(flat_fn, mesh):
    """Run ``flat_fn(nodes, tris, origins [N,3], dirs [N,3], t_max [N])`` with
    the rays split over every axis of ``mesh`` and the tree replicated.  The
    ray count is padded to a multiple of the device count."""
    if mesh is None:
        return flat_fn
    spec = P(tuple(mesh.axis_names))
    sharded = jax.shard_map(flat_fn, mesh=mesh,
                            in_specs=(P(), P(), spec, spec, spec),
                            out_specs=spec, check_vma=False)

    def fn(nodes, tris, origins, dirs, t_max):
        n = t_max.shape[0]
        pad = (-n) % mesh.size
        if pad:
            origins = jnp.pad(origins, ((0, pad), (0, 0)))
            dirs = jnp.pad(dirs, ((0, pad), (0, 0)), constant_values=1.0)
            t_max = jnp.pad(t_max, (0, pad))
        out = sharded(nodes, tris, origins, dirs, t_max)
        return jax.tree_util.tree_map(lambda x: x[:n], out)

    return fn


def batched_oracle(flat_fn):
    """Wrap ``flat_fn(nodes, tris, origins, dirs, t_max)`` so that vmap folds
    the batch axis into the ray axis: one call over B*N rays instead of a
    per-element loop.  The tree arguments must not be batched."""

    @jax.custom_batching.custom_vmap
    def fn(nodes, tris, origins, dirs, t_max):
        return flat_fn(nodes, tris, origins, dirs, t_max)

    @fn.def_vmap
    def _rule(axis_size, in_batched, nodes, tris, origins, dirs, t_max):
        if in_batched[0] or in_batched[1]:
            raise NotImplementedError("cannot vmap the CUDA traversal over trees")
        rays = []
        for x, batched, width in ((origins, in_batched[2], (3,)),
                                  (dirs, in_batched[3], (3,)),
                                  (t_max, in_batched[4], ())):
            if not batched:
                x = jnp.broadcast_to(x, (axis_size,) + x.shape)
            rays.append(x.reshape((-1,) + width))
        out = fn(nodes, tris, *rays)
        out = jax.tree_util.tree_map(
            lambda y: y.reshape((axis_size, -1) + y.shape[1:]), out)
        return out, jax.tree_util.tree_map(lambda _: True, out)

    return fn


def cuda_oracles(scene: Scene, bvh: BVH, mesh=None):
    """(closest(o, d) -> Hit, occluded(o, d, t_max) -> bool) through the CUDA
    kernel, spheres merged by brute force like the jnp BVH oracles.

    Inputs are stop-gradded: the oracle contract (ops/intersect.py) keeps
    traversal out of differentiation, and the kernel has no derivative."""
    require_gpu()
    _register()
    tree = jax.tree_util.tree_map(jax.lax.stop_gradient, bvh)
    nodes = pack_nodes(tree)
    tris = pack_triangles(tree)
    closest_call = batched_oracle(on_mesh(_closest_call, mesh))
    occluded_call = batched_oracle(on_mesh(_occluded_call, mesh))

    def closest(origins, dirs):
        origins = jax.lax.stop_gradient(origins)
        dirs = jax.lax.stop_gradient(dirs)
        t_max = jnp.full(origins.shape[:1], jnp.inf, jnp.float32)
        t, prim, u, v = closest_call(nodes, tris, origins, dirs, t_max)
        return closest_with_spheres(scene, Hit(t=t, prim_id=prim, u=u, v=v),
                                    origins, dirs)

    def occluded(origins, dirs, t_max):
        origins = jax.lax.stop_gradient(origins)
        dirs = jax.lax.stop_gradient(dirs)
        t_max = jax.lax.stop_gradient(t_max).astype(jnp.float32)
        blocked = occluded_call(nodes, tris, origins, dirs, t_max)
        return occluded_with_spheres(scene, blocked, origins, dirs, t_max)

    return closest, occluded
