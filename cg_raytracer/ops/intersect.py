"""Primitive intersectors, vectorized over ray batches.

Reference capability: ``src/ray_tracing.cpp``:
- ray-triangle (plane + inside-test + barycentric areas, :86-114) -> replaced by
  branch-free Moller-Trumbore (better numerics, natural barycentrics for normal
  interpolation and for the VJP to vertex positions),
- ray-sphere quadratic (:118-158),
- ray-AABB slab test (:162-200),
- brute-force mesh intersection (:202-213).

Design contract shared by every backend (brute-force jnp, jnp BVH, CUDA BVH): an
intersection query returns a ``Hit(t, prim_id, u, v)`` batch.  The traversal /
search is treated as a non-differentiable oracle; shading *recomputes* the hit
point, normal, and barycentrics differentiably from ``prim_id`` (see
``reconstruct_hit``), so gradients flow to vertices/normals/materials through a
single gather regardless of which backend found the hit.

prim_id convention: -1 = miss, [0, T) = triangle index, T + s = sphere s.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.types import Scene
from .linalg import dot, normalize, safe_normalize

INF = jnp.float32(jnp.inf)
MISS = jnp.int32(-1)


class Hit(NamedTuple):
    t: jax.Array  # [N] f32, inf on miss
    prim_id: jax.Array  # [N] i32, -1 on miss
    u: jax.Array  # [N] f32 barycentric of v1 (triangles only)
    v: jax.Array  # [N] f32 barycentric of v2


class Surface(NamedTuple):
    """Differentiable surface attributes reconstructed at hit points."""

    valid: jax.Array  # [N] bool
    position: jax.Array  # [N,3]
    normal: jax.Array  # [N,3] shading normal (interpolated, camera-facing)
    kd: jax.Array  # [N,3]
    ks: jax.Array  # [N,3]
    shininess: jax.Array  # [N]


BARY_EPS = 1e-6
# reconstruct_hit gathers per-ray triangle rows with a one-hot matmul up to
# this triangle count, with a plain row gather above it.  On an H100 SXM
# (700 W) the one-hot form took cornell's 1024^2 fwd+bwd to 3.9-4.1 ms against
# 7.8-8.2 ms with the row gather, whose backward is a scatter-add.
ONEHOT_GATHER_MAX_TRIS = 128


def moller_trumbore(origins, dirs, v0, v1, v2, eps: float = 1e-9):
    """Batched Moller-Trumbore. origins/dirs [..., 3] vs v0/v1/v2 [..., 3] broadcast.

    Returns (t, u, v, valid). Accepts front and back faces (the reference's
    plane-based test is double-sided, ray_tracing.cpp:90-107); hits behind the origin
    (t < 0) are invalid, matching intersectRayWithPlane's ``t < 0`` reject (:59-62).

    The inside-test carries a small barycentric tolerance (BARY_EPS): rays grazing a
    shared edge/vertex land exactly on the u/v = 0 boundary, where XLA's FMA
    contraction can flip the sign of the computed barycentric by an ulp between
    differently-fused compilations; the tolerance makes edge hits consistent across
    backends (the reference's inside-test is likewise edge-inclusive,
    ray_tracing.cpp:33).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(dirs, e2)
    det = dot(e1, pvec)
    ok_det = jnp.abs(det) > eps
    # det_safe: keep the masked 1/det branch finite so its VJP cannot emit
    # inf * 0 = NaN on degenerate/parallel triangles (bitwise-identical fwd).
    det_safe = jnp.where(ok_det, det, 1.0)
    inv_det = jnp.where(ok_det, 1.0 / det_safe, 0.0)
    tvec = origins - v0
    u = dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = dot(dirs, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (jnp.abs(det) > eps)
        & (u >= -BARY_EPS)
        & (v >= -BARY_EPS)
        & (u + v <= 1.0 + BARY_EPS)
        & (t >= 0.0)
    )
    return t, u, v, valid


def intersect_plane(origins, dirs, normal, d):
    """Ray-plane intersection, parity with ``intersectRayWithPlane``
    (ray_tracing.cpp:40-72): plane is dot(x, normal) == d; returns (t, valid) with
    t >= 0 (behind-origin rejected), parallel rays invalid, origin-on-plane -> t=0.
    """
    denom = dot(dirs, normal)
    num = d - dot(origins, normal)
    on_plane = num == 0.0
    t = jnp.where(jnp.abs(denom) > 0.0, num / jnp.where(denom == 0.0, 1.0, denom), -1.0)
    t = jnp.where(on_plane, 0.0, t)
    valid = on_plane | ((denom != 0.0) & (t >= 0.0))
    return jnp.where(valid, t, INF), valid


def intersect_spheres_one(origins, dirs, center, radius):
    """Ray-sphere quadratic, parity with ray_tracing.cpp:118-158.

    Returns (t, valid): smaller root if >= 0, else bigger root if >= 0 (inside),
    else miss.
    """
    oc = origins - center
    a = dot(dirs, dirs)
    b = 2.0 * dot(dirs, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_small = (-b - sq) / (2.0 * a)
    t_big = (-b + sq) / (2.0 * a)
    t = jnp.where(t_small >= 0.0, t_small, t_big)
    valid = (disc >= 0.0) & (t >= 0.0)
    return jnp.where(valid, t, INF), valid


def intersect_aabb(origins, inv_dirs, lo, hi):
    """Slab test, parity with ray_tracing.cpp:162-200.

    Returns (t_entry, hitmask) where hitmask is True when the ray segment
    [0, inf) overlaps the box (origin inside counts as hit with t_entry <= 0).
    IEEE inf semantics handle axis-parallel rays like the reference's float division.
    """
    t0 = (lo - origins) * inv_dirs
    t1 = (hi - origins) * inv_dirs
    t_in = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_out = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (t_in <= t_out) & (t_out >= 0.0)
    return t_in, hit


def _gather_tri_vertices(scene: Scene, tri_ids):
    tris = scene.triangles[tri_ids]  # [..., 3]
    v0 = scene.vertices[tris[..., 0]]
    v1 = scene.vertices[tris[..., 1]]
    v2 = scene.vertices[tris[..., 2]]
    return v0, v1, v2, tris


def intersect_brute(scene: Scene, origins, dirs, t_max=None, tri_chunk: int = 2048) -> Hit:
    """Closest-hit over all triangles + spheres by brute force.

    Vectorized replacement for the reference's per-mesh triangle loop
    (ray_tracing.cpp:202-213) and the sphere loop in bvh::intersect
    (bounding_volume_hierarchy.cpp:878-879): one fused [rays x tri_chunk]
    elementwise sweep with a running argmin, scanned over triangle chunks so peak
    memory stays at O(N * tri_chunk) regardless of scene size.
    """
    n = origins.shape[0]
    num_tris = scene.num_triangles
    best = Hit(
        t=jnp.full((n,), jnp.inf, jnp.float32) if t_max is None else jnp.broadcast_to(t_max, (n,)).astype(jnp.float32),
        prim_id=jnp.full((n,), MISS),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
    )

    if num_tris > 0:
        chunk = min(tri_chunk, num_tris)
        num_chunks = -(-num_tris // chunk)
        padded = num_chunks * chunk
        # Pad triangle ids; padding repeats triangle 0 but is masked out below.
        tri_ids = jnp.arange(padded, dtype=jnp.int32)
        tri_ids = jnp.where(tri_ids < num_tris, tri_ids, 0)
        id_chunks = tri_ids.reshape(num_chunks, chunk)
        mask_chunks = (jnp.arange(padded).reshape(num_chunks, chunk) < num_tris)

        def body(carry, inputs):
            ids, mask = inputs
            v0, v1, v2, _ = _gather_tri_vertices(scene, ids)
            t, u, v, valid = moller_trumbore(
                origins[:, None, :], dirs[:, None, :], v0[None], v1[None], v2[None]
            )
            valid = valid & mask[None, :]
            t = jnp.where(valid, t, jnp.inf)
            j = jnp.argmin(t, axis=1)
            rows = jnp.arange(t.shape[0])
            t_new, u_new, v_new = t[rows, j], u[rows, j], v[rows, j]
            closer = t_new < carry.t
            carry = Hit(
                t=jnp.where(closer, t_new, carry.t),
                prim_id=jnp.where(closer, ids[j], carry.prim_id),
                u=jnp.where(closer, u_new, carry.u),
                v=jnp.where(closer, v_new, carry.v),
            )
            return carry, None

        if num_chunks == 1:
            best, _ = body(best, (id_chunks[0], mask_chunks[0]))
        else:
            best, _ = jax.lax.scan(body, best, (id_chunks, mask_chunks))

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        t_s, valid_s = jax.vmap(
            lambda c, r: intersect_spheres_one(origins, dirs, c, r),
            in_axes=(0, 0), out_axes=(0, 0),
        )(scene.spheres.center, scene.spheres.radius)  # [S, N]
        t_s = jnp.where(valid_s, t_s, jnp.inf)
        s = jnp.argmin(t_s, axis=0)
        cols = jnp.arange(origins.shape[0])
        t_best_s = t_s[s, cols]
        closer = t_best_s < best.t
        best = Hit(
            t=jnp.where(closer, t_best_s, best.t),
            prim_id=jnp.where(closer, num_tris + s.astype(jnp.int32), best.prim_id),
            u=jnp.where(closer, 0.0, best.u),
            v=jnp.where(closer, 0.0, best.v),
        )

    # Normalize misses.
    miss = jnp.isinf(best.t) | (best.prim_id < 0)
    return Hit(t=jnp.where(miss, jnp.inf, best.t), prim_id=jnp.where(miss, MISS, best.prim_id),
               u=best.u, v=best.v)


def occluded_brute(scene: Scene, origins, dirs, t_max, tri_chunk: int = 2048):
    """Any-hit query: True where some primitive lies at t in [0, t_max).

    This is the shadow-ray fast path: the reference answers it with a full
    closest-hit ``bvh.intersect`` plus a distance compare (main.cpp:115-131); an
    any-hit reduction does strictly less work.
    """
    n = origins.shape[0]
    num_tris = scene.num_triangles
    blocked = jnp.zeros((n,), bool)

    if num_tris > 0:
        chunk = min(tri_chunk, num_tris)
        num_chunks = -(-num_tris // chunk)
        padded = num_chunks * chunk
        tri_ids = jnp.arange(padded, dtype=jnp.int32)
        tri_ids = jnp.where(tri_ids < num_tris, tri_ids, 0)
        id_chunks = tri_ids.reshape(num_chunks, chunk)
        mask_chunks = (jnp.arange(padded).reshape(num_chunks, chunk) < num_tris)

        def body(carry, inputs):
            ids, mask = inputs
            v0, v1, v2, _ = _gather_tri_vertices(scene, ids)
            t, _, _, valid = moller_trumbore(
                origins[:, None, :], dirs[:, None, :], v0[None], v1[None], v2[None]
            )
            hit = valid & mask[None, :] & (t < t_max[:, None])
            return carry | jnp.any(hit, axis=1), None

        if num_chunks == 1:
            blocked, _ = body(blocked, (id_chunks[0], mask_chunks[0]))
        else:
            blocked, _ = jax.lax.scan(body, blocked, (id_chunks, mask_chunks))

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        t_s, valid_s = jax.vmap(
            lambda c, r: intersect_spheres_one(origins, dirs, c, r),
            in_axes=(0, 0), out_axes=(0, 0),
        )(scene.spheres.center, scene.spheres.radius)
        blocked = blocked | jnp.any(valid_s & (t_s < t_max[None, :]), axis=0)

    return blocked


def reconstruct_hit(scene: Scene, origins, dirs, hit: Hit) -> Surface:
    """Differentiable surface reconstruction from (stop-gradded) prim ids.

    Recomputes t/u/v with Moller-Trumbore on the *single* hit triangle per ray, then
    interpolates the shading normal with barycentric weights and flips it toward the
    camera — parity with ray_tracing.cpp:94-106 (barycentric normal interpolation +
    ``dot(faceNormal, -dir) > 0`` facing flip).  Sphere hits recompute the quadratic
    and use the geometric normal (ray_tracing.cpp:156).

    Gather layout: all per-triangle attributes (3 vertices, 3 normals, material) are
    packed into one [T, 25] table so each ray does a *single* wide row gather
    instead of 7+ separate [N, 3] gathers (the gather is differentiable, so
    vertex/normal/material grads flow through the pack and transpose back as
    scatter-adds).
    """
    num_tris = scene.num_triangles
    prim = jax.lax.stop_gradient(hit.prim_id)
    valid = prim >= 0
    is_tri = valid & (prim < num_tris)
    is_sphere = valid & (prim >= num_tris)

    tri_ids = jnp.clip(prim, 0, max(num_tris - 1, 0))
    if num_tris > 0:
        tris = scene.triangles
        mat_id_all = scene.tri_material
        # ONE packed gather, materials pre-expanded per triangle.
        packed = jnp.concatenate(
            [
                scene.vertices[tris[:, 0]], scene.vertices[tris[:, 1]],
                scene.vertices[tris[:, 2]],
                scene.normals[tris[:, 0]], scene.normals[tris[:, 1]],
                scene.normals[tris[:, 2]],
                scene.materials.kd[mat_id_all], scene.materials.ks[mat_id_all],
                scene.materials.shininess[mat_id_all][:, None],
            ],
            axis=1,
        )  # [T, 28]
        if num_tris <= ONEHOT_GATHER_MAX_TRIS:
            # Gather-as-matmul: one_hot(ids) @ table, whose transpose (the
            # vertex/material grad scatter) is also a matmul.  Precision MUST
            # be HIGHEST: a lower default (TF32 on a GPU) quantizes the
            # geometry/material payload, and finite differences then read 0.
            onehot = jax.nn.one_hot(tri_ids, num_tris, dtype=packed.dtype)
            row = jnp.dot(onehot, packed, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        else:
            row = packed[tri_ids]  # [N, 28] — single per-ray row gather
        v0, v1, v2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        n0, n1, n2 = row[..., 9:12], row[..., 12:15], row[..., 15:18]
        kd_tri, ks_tri = row[..., 18:21], row[..., 21:24]
        shin_tri = row[..., 24]
        t_tri, u, v, _ = moller_trumbore(origins, dirs, v0, v1, v2)
        w0 = 1.0 - u - v
        n_interp = safe_normalize(w0[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2)
        face_n = safe_normalize(jnp.cross(v1 - v0, v2 - v0))
        facing = dot(face_n, -dirs) > 0.0
        n_tri = jnp.where(facing[..., None], n_interp, -n_interp)
    else:
        t_tri = jnp.zeros_like(hit.t)
        n_tri = jnp.zeros_like(origins)
        kd_tri = jnp.zeros_like(origins)
        ks_tri = jnp.zeros_like(origins)
        shin_tri = jnp.zeros_like(hit.t)

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        sp_ids = jnp.clip(prim - num_tris, 0, num_spheres - 1)
        center = scene.spheres.center[sp_ids]
        radius = scene.spheres.radius[sp_ids]
        # Differentiable quadratic recompute with the discriminant GATED at
        # the input (the det_safe pattern): intersect_spheres_one's
        # sqrt(max(disc, 0)) has an infinite derivative at disc <= 0, and
        # inf * 0 through the miss-lane where() poisons center/radius grads
        # to NaN (every non-sphere lane evaluates this on a clipped id).
        oc = origins - center
        qa = dot(dirs, dirs)
        qb = 2.0 * dot(dirs, oc)
        qc = dot(oc, oc) - radius * radius
        disc = qb * qb - 4.0 * qa * qc
        disc_ok = disc > 0.0
        sq = jnp.sqrt(jnp.where(disc_ok, disc, 1.0))
        sq = jnp.where(disc_ok, sq, 0.0)
        t_small = (-qb - sq) / (2.0 * qa)
        t_big = (-qb + sq) / (2.0 * qa)
        t_sp = jnp.where(t_small >= 0.0, t_small, t_big)
        t_sp = jnp.where(disc_ok & (t_sp >= 0.0), t_sp, 0.0)
        pos_sp = origins + dirs * t_sp[..., None]
        n_sp = safe_normalize(pos_sp - center)
        kd_sp = scene.spheres.kd[sp_ids]
        ks_sp = scene.spheres.ks[sp_ids]
        shin_sp = scene.spheres.shininess[sp_ids]
    else:
        t_sp = jnp.zeros_like(hit.t)
        n_sp = jnp.zeros_like(origins)
        kd_sp = jnp.zeros_like(origins)
        ks_sp = jnp.zeros_like(origins)
        shin_sp = jnp.zeros_like(hit.t)

    t = jnp.where(is_sphere, t_sp, t_tri)
    t = jnp.where(valid, t, 0.0)
    position = origins + dirs * t[..., None]
    normal = jnp.where(is_sphere[..., None], n_sp, n_tri)
    kd = jnp.where(is_sphere[..., None], kd_sp, kd_tri)
    ks = jnp.where(is_sphere[..., None], ks_sp, ks_tri)
    shininess = jnp.where(is_sphere, shin_sp, shin_tri)
    zero3 = jnp.zeros_like(normal)
    return Surface(
        valid=valid,
        position=jnp.where(valid[..., None], position, zero3),
        normal=jnp.where(valid[..., None], normal, zero3),
        kd=jnp.where(valid[..., None], kd, zero3),
        ks=jnp.where(valid[..., None], ks, zero3),
        shininess=jnp.where(valid, shininess, jnp.ones_like(shininess)),
    )

def record_surface(scene: Scene, origins, dirs, hit: Hit) -> Surface:
    """Phase-1 surface straight from RECORDED oracle outputs (t, u, v, prim)
    — no Möller–Trumbore recompute (VERDICT r4 item 4).

    The two-phase record loop only needs (position, normal, ks, valid) to
    build the next bounce's rays, and it runs entirely in the stop-gradient
    domain (models/whitted.py::_two_phase_records), so consuming the
    recorded t/u/v (instead of recomputing them differentiably, as
    ``reconstruct_hit`` must for phase 2) is exact there:

    - position = o + t * d (ZERO gathers),
    - normal interpolated from the recorded barycentrics over a narrower
      [T, 15] pack (vertex normals + precomputed face normal + pre-expanded
      ks) — one row gather instead of reconstruct's [T, 28],
    - kd/shininess are not needed and return as zeros/ones.

    Sphere hits (prim >= T) recompute the geometric normal from the recorded
    t (ray_tracing.cpp:156).  Requires records whose Hit carries real u/v —
    all oracle sources do since round 5 (record_trace emitted placeholders
    before).
    """
    num_tris = scene.num_triangles
    prim = jax.lax.stop_gradient(hit.prim_id)
    t_rec = jax.lax.stop_gradient(hit.t)
    u = jax.lax.stop_gradient(hit.u)
    v = jax.lax.stop_gradient(hit.v)
    valid = prim >= 0
    is_sphere = valid & (prim >= num_tris)
    t = jnp.where(valid & jnp.isfinite(t_rec), t_rec, 0.0)
    position = origins + dirs * t[..., None]

    if num_tris > 0:
        tris = scene.triangles
        mat_id_all = scene.tri_material
        face_n = safe_normalize(jnp.cross(
            scene.vertices[tris[:, 1]] - scene.vertices[tris[:, 0]],
            scene.vertices[tris[:, 2]] - scene.vertices[tris[:, 0]]))
        packed = jnp.concatenate(
            [
                scene.normals[tris[:, 0]], scene.normals[tris[:, 1]],
                scene.normals[tris[:, 2]], face_n,
                scene.materials.ks[mat_id_all],
            ],
            axis=1,
        )  # [T, 15]
        row = packed[jnp.clip(prim, 0, num_tris - 1)]
        n0, n1, n2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        fn = row[..., 9:12]
        ks_tri = row[..., 12:15]
        w0 = 1.0 - u - v
        n_interp = safe_normalize(
            w0[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2)
        facing = dot(fn, -dirs) > 0.0
        n_tri = jnp.where(facing[..., None], n_interp, -n_interp)
    else:
        n_tri = jnp.zeros_like(origins)
        ks_tri = jnp.zeros_like(origins)

    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres > 0:
        sp_ids = jnp.clip(prim - num_tris, 0, num_spheres - 1)
        n_sp = safe_normalize(position - scene.spheres.center[sp_ids])
        ks_sp = scene.spheres.ks[sp_ids]
    else:
        n_sp = jnp.zeros_like(origins)
        ks_sp = jnp.zeros_like(origins)

    normal = jnp.where(is_sphere[..., None], n_sp, n_tri)
    ks = jnp.where(is_sphere[..., None], ks_sp, ks_tri)
    zero3 = jnp.zeros_like(normal)
    return Surface(
        valid=valid,
        position=jnp.where(valid[..., None], position, zero3),
        normal=jnp.where(valid[..., None], normal, zero3),
        kd=zero3,
        ks=jnp.where(valid[..., None], ks, zero3),
        shininess=jnp.ones(prim.shape, jnp.float32),
    )
