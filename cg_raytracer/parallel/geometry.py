"""Geometry-sharded rendering: the "tensor-parallel" analogue for huge scenes.

Reference capability: none — the reference replicates the whole scene in every
thread's shared memory (``main.cpp:653-656``).  SURVEY §5 promised the
extension: "geometry replicated (small scenes) or primitive-sharded with
all-gather (dragon-scale)" (SURVEY.md:289) — this module is that path, for
scenes whose triangles and tree outgrow one device's memory.

Design (shard_map over a 'prims' mesh axis):

- **Partition**: triangles are morton-sorted by centroid host-side and split
  into S equal contiguous chunks (padded with degenerate never-hit triangles),
  so each chunk is spatially compact and its sub-BVH is tight.
- **Per-device state**: each device holds only its chunk's triangle buffer,
  material ids, and acceleration structure — the O(T) node and triangle
  tables that cap scene size shrink to O(T/S) per device.  Vertices,
  normals, the material table, lights, and spheres stay replicated (O(V) HBM,
  not the binding constraint).
- **Traversal**: every device traces the full ray batch against its shard
  through the normal per-shard backend (brute / jnp BVH / CUDA kernel —
  ``make_backend`` routes by the *shard* size).
- **Reduction**: the per-ray closest hit is min-reduced across the axis
  (``pmin`` on t, lowest-shard tie-break) and the differentiable surface is
  reconstructed on the winning shard only, then ``psum``-assembled — no
  [S, N]-shaped all-gather ever materializes.  Shadow any-hits OR-reduce.
- A 2-D ('rays', 'prims') mesh composes this with the pixel-grid DP axis:
  pass ``ray_axis='rays'`` and each device traces only its ray rows against
  its geometry shard.

The reduction preserves the oracle contract (ops/intersect.py): results match
a replicated render except on coincident-t tie-breaks across shard boundaries
(tested < 0.5% of pixels, like any backend pair).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models.whitted import REFLECT_EPS, make_backend, needs_bvh
from ..ops import camera as cam_ops
from ..ops import shading
from ..ops.bvh import build_bvh
from ..ops.intersect import MISS, Hit, Surface, reconstruct_hit
from ..ops.linalg import reflect, safe_normalize
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

PRIM_AXIS = "prims"


class GeometryShards(NamedTuple):
    """Host-built per-shard geometry, stacked on a leading shard axis [S, ...].

    ``accel`` is a stacked BVH (every array leaf [S, ...], padded to equal
    shapes across shards) or None for the brute backend.  ``perm`` maps (shard, local slot) -> original triangle id
    (-1 on padding) so sharded hits can be reported in global ids.
    """

    tris: Any  # [S, K, 3] i32 (global vertex indices)
    tri_mat: Any  # [S, K] i32
    perm: Any  # [S, K] i32
    accel: Any  # stacked accel pytree or None
    n_shards: int  # static
    shard_size: int  # static


jax.tree_util.register_pytree_node(
    GeometryShards,
    lambda g: ((g.tris, g.tri_mat, g.perm, g.accel), (g.n_shards, g.shard_size)),
    lambda aux, ch: GeometryShards(*ch, n_shards=aux[0], shard_size=aux[1]),
)


def _morton30(centroids: np.ndarray) -> np.ndarray:
    """30-bit 3-D morton code of centroids normalized to their AABB."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip((centroids - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))


def _shard_scene(scene: Scene, tris, tri_mat) -> Scene:
    """Scene view holding one shard's triangles (vertices etc. shared)."""
    return dataclasses.replace(scene, triangles=tris, tri_material=tri_mat)


def build_geometry_shards(scene: Scene, n_shards: int,
                          cfg: RenderConfig) -> GeometryShards:
    """Host-side partition + per-shard accel build (outside jit, like
    ``build_accel``).  Chunks are morton-contiguous so sub-BVHs stay tight."""
    T = scene.num_triangles
    if T == 0:
        raise ValueError("geometry sharding requires a non-empty triangle buffer")
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    verts = np.asarray(scene.vertices)
    tris = np.asarray(scene.triangles)
    tri_mat = np.asarray(scene.tri_material)
    cent = (verts[tris[:, 0]] + verts[tris[:, 1]] + verts[tris[:, 2]]) / 3.0
    order = np.argsort(_morton30(cent), kind="stable").astype(np.int32)

    K = -(-T // n_shards)
    pad = n_shards * K - T
    # Padding: degenerate triangle (0,0,0) — zero area, MT det == 0, never hits.
    perm = np.concatenate([order, np.full(pad, -1, np.int32)])
    tris_p = np.concatenate([tris[order], np.zeros((pad, 3), np.int32)])
    mat_p = np.concatenate([tri_mat[order], np.zeros(pad, np.int32)])
    tris_s = tris_p.reshape(n_shards, K, 3)
    mat_s = mat_p.reshape(n_shards, K)
    perm_s = perm.reshape(n_shards, K)

    accel = None
    if needs_bvh(cfg, K):
        accels = [build_bvh(_shard_scene(scene, jnp.asarray(tris_s[s]),
                                         jnp.asarray(mat_s[s])),
                            builder=cfg.resolve_bvh_builder())
                  for s in range(n_shards)]
        accel = _stack_padded_accels(accels)

    return GeometryShards(
        tris=jnp.asarray(tris_s),
        tri_mat=jnp.asarray(mat_s),
        perm=jnp.asarray(perm_s),
        accel=accel,
        n_shards=n_shards,
        shard_size=K,
    )


def _stack_padded_accels(accels):
    """Stack per-shard BVHs on a new leading axis, padding each array leaf
    to the max shape so every shard is SPMD-identical.  Padding nodes and
    triangle slots are unreachable (traversal only follows links from the
    root); 1-D int32 leaves pad with -1 (the miss id for ``tri_order``)."""
    kinds = {type(a) for a in accels}
    if len(kinds) != 1:
        raise ValueError(f"shards resolved to different accel types: {kinds}")
    leaves_list = [jax.tree_util.tree_flatten(a) for a in accels]
    treedef = leaves_list[0][1]
    if any(td != treedef for _, td in leaves_list[1:]):
        raise ValueError("shard accel pytrees have mismatched structure "
                         "(e.g. different static leaf widths)")
    stacked = []
    for li in range(len(leaves_list[0][0])):
        arrs = [np.asarray(ls[li]) for ls, _ in leaves_list]
        tgt = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
        fill = -1 if arrs[0].dtype == np.int32 and arrs[0].ndim == 1 else 0
        padded = []
        for a in arrs:
            widths = [(0, t - s) for s, t in zip(a.shape, tgt)]
            padded.append(np.pad(a, widths, constant_values=fill))
        stacked.append(jnp.asarray(np.stack(padded)))
    return jax.tree_util.tree_unflatten(treedef, stacked)


def _local(tree):
    """Strip the leading length-1 shard axis shard_map leaves on array leaves."""
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def _merge_hit_across_shards(hit: Hit, axis: str):
    """Cross-shard closest-hit reduction: pmin on t, lowest shard wins ties.
    Returns (hit_mine: Hit valid only on this shard's winning rays, mine: bool)."""
    idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.psum(1, axis)
    t_min = jax.lax.pmin(hit.t, axis)
    claim = (hit.prim_id >= 0) & (hit.t <= t_min)
    winner = jax.lax.pmin(jnp.where(claim, idx, n_shards), axis)
    mine = claim & (idx == winner)
    hit_mine = Hit(
        t=jnp.where(mine, hit.t, jnp.inf),
        prim_id=jnp.where(mine, hit.prim_id, MISS),
        u=jnp.where(mine, hit.u, 0.0),
        v=jnp.where(mine, hit.v, 0.0),
    )
    return hit_mine, mine


def _merge_surface_across_shards(surf: Surface, axis: str) -> Surface:
    """psum-assemble the winning shard's reconstruction (losing shards carry
    zeros; reconstruct_hit zeroes every field of invalid rays except shininess,
    which it sets to 1 — masked here before the reduce)."""
    valid = jax.lax.psum(surf.valid.astype(jnp.float32), axis) > 0
    shin = jax.lax.psum(jnp.where(surf.valid, surf.shininess, 0.0), axis)
    return Surface(
        valid=valid,
        position=jax.lax.psum(surf.position, axis),
        normal=jax.lax.psum(surf.normal, axis),
        kd=jax.lax.psum(surf.kd, axis),
        ks=jax.lax.psum(surf.ks, axis),
        shininess=jnp.where(valid, shin, 1.0),
    )


def _trace_rays_sharded(scene_s: Scene, origins, dirs, cfg: RenderConfig,
                        backend, key, axis: str):
    """The trace_rays bounce loop (models/whitted.py) with every intersection
    oracle answered collectively across the 'prims' axis."""

    def occluded_global(o, d, tm):
        return jax.lax.psum(backend.occluded(o, d, tm).astype(jnp.int32), axis) > 0

    n = origins.shape[0]
    color = jnp.zeros((n, 3), jnp.float32)
    throughput = jnp.ones((n, 3), jnp.float32)
    active = jnp.ones((n,), bool)

    # Park deactivated rays outside the scene AABB, pointing away, so they
    # fail the root box test and leave traversal at once.
    verts = jax.lax.stop_gradient(scene_s.vertices)
    scene_lo, scene_hi = jnp.min(verts, axis=0), jnp.max(verts, axis=0)
    park = scene_hi + (scene_hi - scene_lo) + 1.0

    o, d = origins, dirs
    for level in range(cfg.max_depth):
        if level > 0:
            o = jnp.where(active[:, None], o, park)
            d = jnp.where(active[:, None], d,
                          jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
        hit_local = backend.closest(o, d)
        hit_mine, _ = _merge_hit_across_shards(hit_local, axis)
        surf = _merge_surface_across_shards(
            reconstruct_hit(scene_s, o, d, hit_mine), axis)
        lkey = jax.random.fold_in(key, level)
        direct = shading.direct_light(
            scene_s, d, surf, occluded_global, lkey,
            soft_shadow_samples=cfg.soft_shadow_samples,
            sample_chunk=cfg.soft_shadow_chunk,
        )
        lit = active & surf.valid
        color = color + throughput * direct * lit[..., None].astype(jnp.float32)

        if level + 1 >= cfg.max_depth:
            break
        if cfg.reference_quirks:
            reflective = surf.ks[..., 2] > 0.01  # main.cpp:246 comma quirk
        else:
            reflective = jnp.any(surf.ks > 0.01, axis=-1)
        active = lit & reflective
        throughput = throughput * surf.ks
        refl_dir = safe_normalize(reflect(d, surf.normal))
        o = surf.position + REFLECT_EPS * refl_dir
        d = jnp.where(active[..., None], refl_dir, d)

    return color


def _shard_body(tris, tri_mat, accel, scene_rest, o, d, key, *,
                cfg: RenderConfig, axis: str):
    scene_s = _shard_scene(scene_rest, tris[0], tri_mat[0])
    accel_s = _local(accel) if accel is not None else None
    backend = make_backend(scene_s, cfg, bvh=accel_s)
    return _trace_rays_sharded(scene_s, o, d, cfg, backend, key, axis)


def geometry_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                            mesh: Mesh, shards: Optional[GeometryShards] = None,
                            key=None, axis: str = PRIM_AXIS,
                            ray_axis: Optional[str] = None):
    """Render with triangles sharded over ``mesh`` axis ``axis``.

    ``shards`` must come from ``build_geometry_shards(scene, S, cfg)`` with S =
    the axis size (built host-side, outside jit — pass it in render loops).
    ``ray_axis``: optional second mesh axis to additionally shard the ray/pixel
    rows (the DP axis), composing "TP x DP".  Returns [H, W, 3] like
    ``render_image``; AA / bloom / motion blur compose as post-passes.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n_shards = mesh.shape[axis]
    if shards is None:
        shards = build_geometry_shards(scene, n_shards, cfg)
    if shards.n_shards != n_shards:
        raise ValueError(
            f"shards were built for {shards.n_shards} shards but mesh axis "
            f"{axis!r} has size {n_shards}")

    scene_rest = dataclasses.replace(
        scene,
        triangles=jnp.zeros((0, 3), jnp.int32),
        tri_material=jnp.zeros((0,), jnp.int32),
    )
    rspec = P(ray_axis) if ray_axis else P()
    body = functools.partial(_shard_body, cfg=cfg, axis=axis)
    traced = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis) if shards.accel is not None else P(),
                  P(), rspec, rspec, P()),
        out_specs=rspec,
        check_vma=False,
    )

    from ..ops import effects

    @functools.partial(jax.jit, static_argnames=())
    def run(shards_, scene_rest_, camera_, key_):
        def flat_render(camera__, key__, off):
            o, d = cam_ops.generate_rays(camera__, cfg.height, cfg.width,
                                         offset=off)
            color = traced(shards_.tris, shards_.tri_mat, shards_.accel,
                           scene_rest_, o, d, key__)
            return color.reshape(cfg.height, cfg.width, 3)

        def base(camera__, key__):
            if cfg.anti_aliasing:
                return effects.supersample_render(
                    lambda off: flat_render(camera__, key__, off), cfg)
            return flat_render(camera__, key__, (0.0, 0.0))

        if cfg.motion_blur:
            img = effects.motion_blur(base, camera_, cfg, key_)
        else:
            img = base(camera_, key_)
        if cfg.bloom:
            img = effects.bloom(img, cfg)
        return img

    with mesh:
        return run(shards, scene_rest, camera, key)


def geometry_sharded_intersect(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                               shards: GeometryShards, origins, dirs,
                               axis: str = PRIM_AXIS) -> Hit:
    """Closest-hit oracle through the sharded geometry, reported in GLOBAL
    primitive ids (via the shard permutation table) — the testable contract
    that the reduction preserves the single-device oracle."""
    scene_rest = dataclasses.replace(
        scene,
        triangles=jnp.zeros((0, 3), jnp.int32),
        tri_material=jnp.zeros((0,), jnp.int32),
    )
    K = shards.shard_size
    num_tris_global = scene.num_triangles

    def body(tris, tri_mat, perm, accel, scene_rest_, o, d):
        scene_s = _shard_scene(scene_rest_, tris[0], tri_mat[0])
        accel_s = _local(accel) if accel is not None else None
        backend = make_backend(scene_s, cfg, bvh=accel_s)
        hit = backend.closest(o, d)
        hit_mine, mine = _merge_hit_across_shards(hit, axis)
        # Local -> global prim ids: triangles map through perm; sphere ids
        # (>= K locally) shift from the local to the global triangle count.
        is_tri = hit_mine.prim_id >= 0
        is_sph = hit_mine.prim_id >= K
        safe = jnp.clip(hit_mine.prim_id, 0, K - 1)
        gp = jnp.where(is_sph, hit_mine.prim_id - K + num_tris_global,
                       jnp.where(is_tri, perm[0][safe], MISS))
        t = jax.lax.pmin(hit_mine.t, axis)
        red = lambda x: jax.lax.psum(jnp.where(mine, x, 0), axis)
        prim = jax.lax.psum(jnp.where(mine, gp, 0), axis)
        any_mine = jax.lax.psum(mine.astype(jnp.int32), axis) > 0
        return Hit(t=t, prim_id=jnp.where(any_mine, prim, MISS),
                   u=red(hit_mine.u), v=red(hit_mine.v))

    traced = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis),
                  P(axis) if shards.accel is not None else P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    with mesh:
        return jax.jit(traced)(shards.tris, shards.tri_mat, shards.perm,
                               shards.accel, scene_rest, origins, dirs)
