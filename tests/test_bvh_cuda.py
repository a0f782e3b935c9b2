"""CUDA BVH traversal (ops/bvh_cuda.py + native/bvh_traverse.cu).

The host side runs everywhere: record packing round-trips to the ``BVH``,
backend routing by name, the vmap and mesh wrappers (exercised with the jnp
traversal standing in for the kernel), and the refusal to run the kernel
without a GPU.  Tests marked ``gpu`` compare the compiled kernel with the jnp
traversal; they skip off the card and run through ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cg_raytracer as cgrt
from cg_raytracer.models.whitted import make_backend, render_image
from cg_raytracer.ops import bvh_cuda
from cg_raytracer.ops import camera as cam_ops
from cg_raytracer.ops.bvh import build_bvh, intersect_bvh, occluded_bvh, traverse_closest


@pytest.mark.parametrize("name,builder", [("cube", "median"),
                                          ("cornell_box", "median"),
                                          ("monkey", "median"),
                                          ("monkey", "sah")])
def test_node_records_round_trip(scenes, name, builder):
    bvh = build_bvh(scenes(name), builder=builder)
    nodes = np.asarray(bvh_cuda.pack_nodes(bvh))
    assert nodes.dtype == np.int32
    assert nodes.shape == (bvh.num_nodes, bvh_cuda.NODE_WORDS)
    assert (nodes.shape[1] * 4) % 16 == 0  # whole 16-byte records
    lo, hi, left, right, first, count = bvh_cuda.unpack_nodes(nodes)
    np.testing.assert_array_equal(lo, np.asarray(bvh.node_lo))
    np.testing.assert_array_equal(hi, np.asarray(bvh.node_hi))
    np.testing.assert_array_equal(left, np.asarray(bvh.left))
    np.testing.assert_array_equal(right, np.asarray(bvh.right))
    np.testing.assert_array_equal(first, np.asarray(bvh.first))
    np.testing.assert_array_equal(count, np.asarray(bvh.count))


def test_triangle_records(scenes):
    scene = scenes("monkey")
    bvh = build_bvh(scene)
    tris = np.asarray(bvh_cuda.pack_triangles(bvh))
    assert tris.dtype == np.int32
    assert tris.shape == (scene.num_triangles, bvh_cuda.TRI_WORDS)
    as_f = tris.view(np.float32)
    tv0, tv1, tv2 = (np.asarray(x) for x in (bvh.tv0, bvh.tv1, bvh.tv2))
    np.testing.assert_array_equal(as_f[:, 0:3], tv0)
    np.testing.assert_array_equal(as_f[:, 4:7], tv1 - tv0)
    np.testing.assert_array_equal(as_f[:, 8:11], tv2 - tv0)
    # Slot -> original triangle id rides in v0's fourth word.
    np.testing.assert_array_equal(tris[:, 3], np.asarray(bvh.tri_order))
    np.testing.assert_array_equal(tris[:, 7], 0)
    np.testing.assert_array_equal(tris[:, 11], 0)


def test_pack_is_jittable_and_matches_host(scenes):
    bvh = build_bvh(scenes("cornell_box"))
    np.testing.assert_array_equal(np.asarray(jax.jit(bvh_cuda.pack_nodes)(bvh)),
                                  np.asarray(bvh_cuda.pack_nodes(bvh)))


@pytest.mark.parametrize("backend,platform,num_tris,want", [
    ("auto", "gpu", 32, "brute"),
    ("auto", "gpu", 4096, "brute"),
    ("auto", "gpu", 4097, "cuda"),
    ("auto", "cpu", 87_780, "bvh"),
    ("bvh", "gpu", 87_780, "bvh"),
    ("cuda", "gpu", 32, "cuda"),
    ("brute", "gpu", 320_000, "brute"),
])
def test_backend_routing_by_name(backend, platform, num_tris, want):
    cfg = cgrt.RenderConfig(backend=backend)
    assert cfg.resolve_backend(num_tris, platform=platform) == want


def test_unknown_backend_name_raises():
    with pytest.raises(ValueError, match="backend must be one of"):
        cgrt.RenderConfig(backend="pallas").resolve_backend(10, platform="gpu")


def test_cuda_backend_without_gpu_raises(scenes):
    assert jax.default_backend() != "gpu"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        make_backend(scenes("cube"), cgrt.RenderConfig(backend="cuda"))


def _jnp_flat(bvh):
    """Stand-in for the kernel call: same signature, jnp traversal inside."""

    def flat(nodes, tris, origins, dirs, t_max):
        hit, _ = traverse_closest(bvh, origins, dirs, t_max=t_max)
        return hit.t, hit.prim_id

    return flat


def test_batched_oracle_folds_vmap_into_rays(scenes):
    scene = scenes("monkey")
    bvh = build_bvh(scene)
    nodes, tris = bvh_cuda.pack_nodes(bvh), bvh_cuda.pack_triangles(bvh)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 8, 8)
    calls = []

    def flat(nodes_, tris_, o_, d_, tm_):
        calls.append(o_.shape)
        return _jnp_flat(bvh)(nodes_, tris_, o_, d_, tm_)

    oracle = bvh_cuda.batched_oracle(flat)
    # Batched rays with an unbatched t_max, as a vmap over lights produces.
    shifts = jnp.asarray([0.0, 0.01, -0.02], jnp.float32)
    tm = jnp.full((o.shape[0],), jnp.inf, jnp.float32)
    t, prim = jax.vmap(lambda s: oracle(nodes, tris, o + s, d, tm))(shifts)
    assert t.shape == prim.shape == (3, o.shape[0])
    assert calls[-1] == (3 * o.shape[0], 3)  # one call over all rays
    for i, s in enumerate(np.asarray(shifts)):
        hit, _ = traverse_closest(bvh, o + s, d)
        np.testing.assert_array_equal(np.asarray(prim[i]), np.asarray(hit.prim_id))
        np.testing.assert_array_equal(np.asarray(t[i]), np.asarray(hit.t))


def test_batched_oracle_under_grad_with_stop_gradient(scenes):
    # The oracle contract: rays are stop-gradded before the call, so the
    # kernel (which has no derivative) never sees a tangent.
    scene = scenes("monkey")
    bvh = build_bvh(scene)
    oracle = bvh_cuda.batched_oracle(_jnp_flat(bvh))
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 8, 8)
    tm = jnp.full((o.shape[0],), jnp.inf, jnp.float32)

    def loss(x):
        oo = jax.lax.stop_gradient(o * x)
        t, _ = jax.vmap(lambda s: oracle(None, None, oo + s, d, tm))(
            jnp.zeros((2,), jnp.float32))
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0)) * x

    g = jax.grad(loss)(jnp.float32(1.0))
    assert np.isfinite(float(g))


def test_on_mesh_shards_rays_and_pads(scenes):
    from jax.sharding import Mesh

    scene = scenes("monkey")
    bvh = build_bvh(scene)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("rays",))
    fn = jax.jit(bvh_cuda.on_mesh(_jnp_flat(bvh), mesh))
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 9, 7)  # 63 rays: pads
    tm = jnp.full((o.shape[0],), jnp.inf, jnp.float32)
    t, prim = fn(None, None, o, d, tm)
    hit, _ = traverse_closest(bvh, o, d)
    assert prim.shape == (63,)
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(hit.prim_id))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(hit.t))


# ---------------------------------------------------------------------------
# On the card: the compiled kernel against the jnp traversal.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["monkey", "teacup", "dragon"])
def test_cuda_closest_matches_jnp(gpu, scenes, name):
    scene = scenes(name)
    bvh = build_bvh(scene)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 128, 128)
    closest, _ = bvh_cuda.cuda_oracles(scene, bvh)
    hk = jax.jit(closest)(o, d)
    hj = jax.jit(lambda o_, d_: intersect_bvh(scene, bvh, o_, d_))(o, d)
    same = np.asarray(hk.prim_id) == np.asarray(hj.prim_id)
    assert same.mean() >= 0.995
    assert (np.asarray(hj.prim_id) >= 0).any()
    tk, tj = np.asarray(hk.t)[same], np.asarray(hj.t)[same]
    fin = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(tk), fin)
    np.testing.assert_allclose(tk[fin], tj[fin], rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["monkey", "teacup"])
def test_cuda_occluded_matches_jnp(gpu, scenes, name):
    scene = scenes(name)
    bvh = build_bvh(scene)
    o, d = cam_ops.generate_rays(cgrt.Camera.default(), 128, 128)
    hit = intersect_bvh(scene, bvh, o, d)
    ok = np.isfinite(np.asarray(hit.t))
    pos = o + d * jnp.where(jnp.asarray(ok), hit.t, 0.0)[:, None]
    light = jnp.asarray([-1.0, 1.0, -1.0], jnp.float32)
    ldir = light - pos
    dist = jnp.linalg.norm(ldir, axis=-1)
    ldir = ldir / dist[:, None]
    so = pos + 1e-3 * ldir
    _, occluded = bvh_cuda.cuda_oracles(scene, bvh)
    bk = np.asarray(jax.jit(occluded)(so, ldir, dist - 1e-3))
    bj = np.asarray(occluded_bvh(scene, bvh, so, ldir, dist - 1e-3))
    assert (bk == bj).mean() >= 0.995
    assert bj.any() and not bj.all()


@pytest.mark.gpu
def test_cuda_render_and_grads_match_jnp_bvh(gpu, scenes):
    scene = scenes("teacup")
    cam = cgrt.Camera.default()
    cfg_j = cgrt.RenderConfig(width=64, height=64, backend="bvh")
    cfg_k = dataclasses.replace(cfg_j, backend="cuda")
    bvh = build_bvh(scene)

    def loss(kd, cfg):
        s = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, kd=kd))
        return jnp.sum(render_image(s, cam, cfg, backend=make_backend(s, cfg, bvh)))

    for cfg in (cfg_j, cfg_k):
        assert np.isfinite(float(jax.jit(lambda k: loss(k, cfg))(scene.materials.kd)))
    img_j = np.asarray(render_image(scene, cam, cfg_j,
                                    backend=make_backend(scene, cfg_j, bvh)))
    img_k = np.asarray(render_image(scene, cam, cfg_k,
                                    backend=make_backend(scene, cfg_k, bvh)))
    bad = (np.abs(img_j - img_k).max(axis=-1) > 1e-4).mean()
    assert bad <= 0.005
    gj = jax.jit(jax.grad(lambda k: loss(k, cfg_j)))(scene.materials.kd)
    gk = jax.jit(jax.grad(lambda k: loss(k, cfg_k)))(scene.materials.kd)
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gj), rtol=1e-3,
                               atol=1e-3)
