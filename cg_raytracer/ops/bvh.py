"""BVH build + the jnp traversal (every platform's reference traversal).

Reference capability:
- build: binary tree, longest-axis centroid-median split, depth cap, BFS into a flat
  node vector (``src/bounding_volume_hierarchy.cpp:42-464``).  The
  reference's leaves copy whole meshes into each node (bvh.h:6-13); here leaves are
  index *ranges* into one globally reordered triangle buffer — a flattened SoA
  (node_lo/node_hi/left/right/first/count) resident in HBM.
- traversal: ordered near-to-far descent with the current-closest ``ray.t`` as a
  loop-carried bound (``bounding_volume_hierarchy.cpp:535-881``).  Recursion becomes
  a fixed-size explicit stack inside ``lax.while_loop``, vmapped over the ray batch;
  every iteration executes the same masked instruction stream (leaf test + child
  push) for the whole batch.  On a GPU the per-ray CUDA kernel
  (``ops/bvh_cuda.py``) answers the same queries over the same tree.

The builder runs on host (numpy) with an optional native C++ fast path
(``native/bvh_builder.cpp`` via ctypes) — the analogue of the reference's C++ build
step (the ``createTree`` hot loop, bvh.cpp:343-389).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.types import Scene
from .intersect import MISS, Hit, intersect_spheres_one, moller_trumbore

DEFAULT_MAX_DEPTH = 20
DEFAULT_MAX_LEAF = 4


class BVH(NamedTuple):
    """Flattened SoA BVH. Leaf iff count > 0; internal nodes use left/right."""

    node_lo: jax.Array  # [Nn,3] f32
    node_hi: jax.Array  # [Nn,3] f32
    left: jax.Array  # [Nn] i32
    right: jax.Array  # [Nn] i32
    first: jax.Array  # [Nn] i32 (offset into reordered triangle buffer)
    count: jax.Array  # [Nn] i32 (0 for internal nodes)
    tri_order: jax.Array  # [T] i32: reordered position -> original triangle id
    # Reordered triangle vertices (one gather instead of tris->verts indirection).
    tv0: jax.Array  # [T,3]
    tv1: jax.Array
    tv2: jax.Array
    max_leaf: int  # static

    @property
    def num_nodes(self) -> int:
        return self.node_lo.shape[0]


def _build_numpy(tri_lo, tri_hi, centroids, max_depth, max_leaf):
    """Host BVH build: iterative stack, centroid-median split on the longest axis.

    Mirrors the reference's split rule (longest axis of the node box, median of
    centroid-sorted triangles; bvh.cpp:284-289, 192-207) with leaves capped at
    ``max_leaf`` triangles or ``max_depth`` levels.
    Returns (node_lo, node_hi, left, right, first, count, order).
    """
    num_tris = tri_lo.shape[0]
    order = np.arange(num_tris, dtype=np.int32)

    node_lo, node_hi = [], []
    left, right, first, count = [], [], [], []

    def new_node():
        node_lo.append(np.zeros(3, np.float32))
        node_hi.append(np.zeros(3, np.float32))
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        return len(left) - 1

    root = new_node()
    stack = [(root, 0, num_tris, 0)]  # (node_idx, begin, end, depth)
    while stack:
        ni, begin, end, depth = stack.pop()
        ids = order[begin:end]
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        node_lo[ni], node_hi[ni] = lo, hi
        n = end - begin
        if n <= max_leaf or depth >= max_depth:
            first[ni] = begin
            count[ni] = n
            continue
        axis = int(np.argmax(hi - lo))
        cent = centroids[ids, axis]
        mid = n // 2
        part = np.argpartition(cent, mid)
        order[begin:end] = ids[part]
        li, ri = new_node(), new_node()
        left[ni], right[ni] = li, ri
        stack.append((ri, begin + mid, end, depth + 1))
        stack.append((li, begin, begin + mid, depth + 1))

    return (
        np.asarray(node_lo, np.float32),
        np.asarray(node_hi, np.float32),
        np.asarray(left, np.int32),
        np.asarray(right, np.int32),
        np.asarray(first, np.int32),
        np.asarray(count, np.int32),
        order,
    )


def _build_numpy_sah(tri_lo, tri_hi, centroids, max_depth, max_leaf, bins=16):
    """Host BVH build with binned surface-area-heuristic splits.

    Not in the reference (it always splits at the centroid median,
    bvh.cpp:192-207); SAH minimizes expected traversal cost
    ``area(L)*n_L + area(R)*n_R`` over ``bins`` candidate planes per axis,
    Same output contract as ``_build_numpy``.
    """
    num_tris = tri_lo.shape[0]
    order = np.arange(num_tris, dtype=np.int32)

    node_lo, node_hi = [], []
    left, right, first, count = [], [], [], []

    def new_node():
        node_lo.append(np.zeros(3, np.float32))
        node_hi.append(np.zeros(3, np.float32))
        left.append(-1)
        right.append(-1)
        first.append(0)
        count.append(0)
        return len(left) - 1

    def half_area(ext):
        ext = np.maximum(ext, 0.0)
        return ext[..., 0] * ext[..., 1] + ext[..., 1] * ext[..., 2] + ext[..., 2] * ext[..., 0]

    root = new_node()
    stack = [(root, 0, num_tris, 0)]
    while stack:
        ni, begin, end, depth = stack.pop()
        ids = order[begin:end]
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        node_lo[ni], node_hi[ni] = lo, hi
        n = end - begin
        if n <= max_leaf or depth >= max_depth:
            first[ni] = begin
            count[ni] = n
            continue

        cent = centroids[ids]
        clo, chi = cent.min(axis=0), cent.max(axis=0)
        best = None  # (cost, axis, mask_left)
        for axis in range(3):
            ext = np.float64(chi[axis]) - np.float64(clo[axis])
            # Skip near-degenerate axes: a float32-denormal extent overflows
            # bins/ext to inf, and 0*inf -> NaN -> negative int64 -> bincount
            # crash (ADVICE r2).  float64 binning + a hard floor avoids both.
            if ext <= 1e-30:
                continue
            b = np.minimum(
                ((cent[:, axis].astype(np.float64) - np.float64(clo[axis]))
                 * (bins / ext)).astype(np.int64),
                bins - 1)
            cnt = np.bincount(b, minlength=bins)
            blo = np.full((bins, 3), np.inf, np.float32)
            bhi = np.full((bins, 3), -np.inf, np.float32)
            np.minimum.at(blo, b, tri_lo[ids])
            np.maximum.at(bhi, b, tri_hi[ids])
            # Empty bins carry +/-inf sentinels; min/max accumulate ignores them.
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = n - lcnt
            al = half_area(lhi[:-1] - llo[:-1])
            ar = half_area(rhi[1:] - rlo[1:])
            cost = (np.where(lcnt > 0, al * lcnt, 0.0)
                    + np.where(rcnt > 0, ar * rcnt, 0.0))
            # Degenerate splits (one side empty) devolve to no progress: forbid.
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            s = int(np.argmin(cost))
            if np.isfinite(cost[s]) and (best is None or cost[s] < best[0]):
                best = (float(cost[s]), axis, b <= s)
        if best is None:
            # All centroids coincide: median split on the longest axis (ties
            # broken arbitrarily), mirroring the non-SAH builder's fallback.
            mid = n // 2
            mask_left = np.zeros(n, bool)
            mask_left[:mid] = True
        else:
            mask_left = best[2]
        order[begin:end] = np.concatenate([ids[mask_left], ids[~mask_left]])
        mid = int(mask_left.sum())
        li, ri = new_node(), new_node()
        left[ni], right[ni] = li, ri
        stack.append((ri, begin + mid, end, depth + 1))
        stack.append((li, begin, begin + mid, depth + 1))

    return (
        np.asarray(node_lo, np.float32),
        np.asarray(node_hi, np.float32),
        np.asarray(left, np.int32),
        np.asarray(right, np.int32),
        np.asarray(first, np.int32),
        np.asarray(count, np.int32),
        order,
    )


def build_bvh(scene: Scene, max_depth: int = DEFAULT_MAX_DEPTH,
              max_leaf: int = DEFAULT_MAX_LEAF, use_native: bool = True,
              builder: str = "median") -> BVH:
    """Build the flat BVH for a scene's triangle soup (host-side, one-time cost).

    ``builder``: 'median' (reference split rule, bvh.cpp:192-207) or 'sah'
    (binned surface-area heuristic — not in the reference).  Both honor the oracle contract; hit
    results may differ only on coincident-t tie-breaks.

    Splitting leaves with > max_leaf tris past max_depth is impossible, so oversized
    leaves can exist at the depth cap (the reference has the same property at its
    maxDepth=12, bvh.cpp:320-322); traversal handles them by looping leaf chunks.
    """
    verts = np.asarray(scene.vertices)
    tris = np.asarray(scene.triangles)
    num_tris = tris.shape[0]
    if num_tris == 0:
        raise ValueError("Cannot build a BVH over an empty triangle buffer")
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    centroids = (p0 + p1 + p2) / 3.0

    if builder not in ("median", "sah"):
        raise ValueError(f"builder must be 'median' | 'sah', got {builder!r}")
    built = None
    if builder == "sah":
        built = _build_numpy_sah(tri_lo, tri_hi, centroids, max_depth, max_leaf)
    if built is None and use_native:
        try:
            from ..native import native_build_bvh

            built = native_build_bvh(tri_lo, tri_hi, centroids, max_depth, max_leaf)
        except Exception:
            built = None
    if built is None:
        built = _build_numpy(tri_lo, tri_hi, centroids, max_depth, max_leaf)

    node_lo, node_hi, left, right, first, count, order = built
    return BVH(
        node_lo=jnp.asarray(node_lo),
        node_hi=jnp.asarray(node_hi),
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        first=jnp.asarray(first),
        count=jnp.asarray(count),
        tri_order=jnp.asarray(order),
        tv0=jnp.asarray(p0[order]),
        tv1=jnp.asarray(p1[order]),
        tv2=jnp.asarray(p2[order]),
        max_leaf=int(max_leaf),
        )


# Register BVH as a pytree with max_leaf static.
def _bvh_flatten(b: BVH):
    return (b.node_lo, b.node_hi, b.left, b.right, b.first, b.count,
            b.tri_order, b.tv0, b.tv1, b.tv2), b.max_leaf


def _bvh_unflatten(aux, children):
    return BVH(*children, max_leaf=aux)


jax.tree_util.register_pytree_node(BVH, _bvh_flatten, _bvh_unflatten)


def bvh_num_levels(bvh: BVH) -> int:
    """Tree depth (numLevels, bvh.cpp:214-224) — computed host-side."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    depth = np.zeros(left.shape[0], np.int32)
    # Nodes are appended parent-before-child, so a forward sweep suffices.
    for i in range(left.shape[0]):
        for c in (left[i], right[i]):
            if c >= 0:
                depth[c] = depth[i] + 1
    return int(depth.max()) + 1


_SLAB_EPS = 1e-5


def _slab(o, inv_d, lo, hi):
    """Conservative slab test: padded so corner/edge-grazing rays (t_in == t_out up
    to rounding) are never culled — the brute-force oracle accepts them, and scenes
    with axis-aligned geometry (the cube preset) graze constantly."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_in = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_out = jnp.min(jnp.maximum(t0, t1), axis=-1)
    pad = _SLAB_EPS * (1.0 + jnp.abs(t_out))
    hit = (t_in <= t_out + pad) & (t_out >= -pad)
    return t_in, hit


def traverse_closest(bvh: BVH, origins, dirs, t_max=None, max_stack: int = 64,
                     any_hit: bool = False):
    """Closest-hit (or any-hit) BVH traversal over a ray batch.

    Returns Hit(t, reordered_slot, u, v) where prim ids are *original* triangle ids
    (mapped through tri_order).  ``any_hit=True`` exits a ray's loop as soon as any
    intersection below its t bound is found (shadow rays).

    Every while-loop iteration pops one node and executes a fixed masked program:
    up to ``max_leaf`` triangle tests (masked out on internal nodes) plus two child
    slab tests and ordered pushes (masked out on leaves).  Oversized depth-capped
    leaves re-push themselves with an advanced cursor.
    """
    n = origins.shape[0]
    chunk = bvh.max_leaf
    t0 = jnp.full((n,), jnp.inf, jnp.float32) if t_max is None else jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)

    def ray_fn(o, d, t_init):
        inv_d = 1.0 / d
        stack = jnp.zeros((max_stack,), jnp.int32)
        stack_off = jnp.zeros((max_stack,), jnp.int32)  # leaf cursor (0 for fresh nodes)
        # Seed with the root.
        sp = jnp.int32(1)
        state = dict(
            sp=sp, stack=stack, stack_off=stack_off,
            t=t_init, slot=MISS, u=jnp.float32(0), v=jnp.float32(0),
            found=jnp.bool_(False),
        )

        def cond(s):
            go = s["sp"] > 0
            if any_hit:
                go = go & (~s["found"])
            return go

        def body(s):
            sp = s["sp"] - 1
            ni = s["stack"][sp]
            off = s["stack_off"][sp]
            lo = bvh.node_lo[ni]
            hi = bvh.node_hi[ni]
            t_in, box_hit = _slab(o, inv_d, lo, hi)
            box_hit = box_hit & (t_in <= s["t"] + _SLAB_EPS * (1.0 + jnp.abs(s["t"])))

            cnt = bvh.count[ni]
            is_leaf = cnt > 0
            do_leaf = box_hit & is_leaf

            # --- leaf: test up to `chunk` triangles starting at first+off ---
            base = bvh.first[ni] + off
            t_cur, slot_cur, u_cur, v_cur = s["t"], s["slot"], s["u"], s["v"]
            for k in range(chunk):
                idx = base + k
                in_range = do_leaf & (off + k < cnt)
                safe = jnp.where(in_range, idx, 0)
                tv0 = bvh.tv0[safe]
                tv1 = bvh.tv1[safe]
                tv2 = bvh.tv2[safe]
                tt, uu, vv, ok = moller_trumbore(o, d, tv0, tv1, tv2)
                ok = ok & in_range & (tt < t_cur)
                t_cur = jnp.where(ok, tt, t_cur)
                slot_cur = jnp.where(ok, safe, slot_cur)
                u_cur = jnp.where(ok, uu, u_cur)
                v_cur = jnp.where(ok, vv, v_cur)
            found = s["found"] | (do_leaf & (slot_cur != s["slot"]))
            # Oversized leaf: re-push with advanced cursor.
            more = do_leaf & (off + chunk < cnt)
            stack = s["stack"].at[sp].set(ni)
            stack_off = s["stack_off"].at[sp].set(off + chunk)
            sp = sp + jnp.where(more, 1, 0)

            # --- internal: ordered child push (near popped last-in-first-out) ---
            do_int = box_hit & (~is_leaf)
            li = bvh.left[ni]
            ri = bvh.right[ni]
            tl, hl = _slab(o, inv_d, bvh.node_lo[li], bvh.node_hi[li])
            tr, hr = _slab(o, inv_d, bvh.node_lo[ri], bvh.node_hi[ri])
            t_pad = _SLAB_EPS * (1.0 + jnp.abs(t_cur))
            hl = hl & do_int & (tl <= t_cur + t_pad)
            hr = hr & do_int & (tr <= t_cur + t_pad)
            left_near = tl <= tr
            near_i = jnp.where(left_near, li, ri)
            far_i = jnp.where(left_near, ri, li)
            near_h = jnp.where(left_near, hl, hr)
            far_h = jnp.where(left_near, hr, hl)
            # push far first so near is popped first (ordered front-to-back,
            # bvh.cpp:572-595).
            stack = stack.at[sp].set(jnp.where(far_h, far_i, stack[sp]))
            stack_off = stack_off.at[sp].set(jnp.where(far_h, 0, stack_off[sp]))
            sp = sp + jnp.where(far_h, 1, 0)
            stack = stack.at[sp].set(jnp.where(near_h, near_i, stack[sp]))
            stack_off = stack_off.at[sp].set(jnp.where(near_h, 0, stack_off[sp]))
            sp = sp + jnp.where(near_h, 1, 0)

            return dict(sp=sp, stack=stack, stack_off=stack_off,
                        t=t_cur, slot=slot_cur, u=u_cur, v=v_cur, found=found)

        out = jax.lax.while_loop(cond, body, state)
        return out["t"], out["slot"], out["u"], out["v"], out["found"]

    t, slot, u, v, found = jax.vmap(ray_fn)(origins, dirs, t0)
    prim = jnp.where(slot >= 0, bvh.tri_order[jnp.maximum(slot, 0)], MISS)
    miss = slot < 0
    return Hit(t=jnp.where(miss, jnp.inf, t), prim_id=prim, u=u, v=v), found


def closest_with_spheres(scene: Scene, hit: Hit, origins, dirs) -> Hit:
    """Merge brute-force sphere hits into a triangle closest-hit (bvh.cpp:850-881)."""
    num_spheres = scene.spheres.radius.shape[0]
    if num_spheres == 0:
        return hit
    t_s, valid_s = jax.vmap(
        lambda c, r: intersect_spheres_one(origins, dirs, c, r),
        in_axes=(0, 0), out_axes=(0, 0),
    )(scene.spheres.center, scene.spheres.radius)
    t_s = jnp.where(valid_s, t_s, jnp.inf)
    s = jnp.argmin(t_s, axis=0)
    cols = jnp.arange(origins.shape[0])
    t_best_s = t_s[s, cols]
    closer = t_best_s < hit.t
    return Hit(
        t=jnp.where(closer, t_best_s, hit.t),
        prim_id=jnp.where(closer, scene.num_triangles + s.astype(jnp.int32),
                          hit.prim_id),
        u=jnp.where(closer, 0.0, hit.u),
        v=jnp.where(closer, 0.0, hit.v),
    )


def occluded_with_spheres(scene: Scene, blocked, origins, dirs, t_max):
    """OR brute-force sphere blockers into a triangle any-hit result."""
    if scene.spheres.radius.shape[0] == 0:
        return blocked
    t_s, valid_s = jax.vmap(
        lambda c, r: intersect_spheres_one(origins, dirs, c, r),
        in_axes=(0, 0), out_axes=(0, 0),
    )(scene.spheres.center, scene.spheres.radius)
    return blocked | jnp.any(valid_s & (t_s < t_max[None, :]), axis=0)


def intersect_bvh(scene: Scene, bvh: BVH, origins, dirs, t_max=None) -> Hit:
    """Closest-hit through the BVH + brute-force spheres (bvh.cpp:850-881)."""
    hit, _ = traverse_closest(bvh, origins, dirs, t_max=t_max)
    return closest_with_spheres(scene, hit, origins, dirs)


def occluded_bvh(scene: Scene, bvh: BVH, origins, dirs, t_max):
    """Any-hit query through the BVH (shadow rays)."""
    _, found = traverse_closest(bvh, origins, dirs, t_max=t_max, any_hit=True)
    return occluded_with_spheres(scene, found, origins, dirs, t_max)
