"""Device-mesh parallelism: pixel-grid sharding + replicated scene.

Reference capability: the reference's only parallelism is an OpenMP ``parallel for``
over scanlines (``main.cpp:653-656``).  The device-mesh analogue set (SURVEY §2
parallelism table):

- **DP over rays**: the flattened ray/pixel axis is sharded over every device of a
  ``jax.sharding.Mesh`` with ``NamedSharding(P('rays'))``; XLA partitions the whole
  fused render pipeline so each device traces its slice of the grid.  The CUDA
  traversal kernel, which XLA cannot partition, runs under ``shard_map`` over
  the same mesh (``make_backend(..., mesh=mesh)``).
- **Replicated scene ("TP" degenerate case)**: scene buffers carry a replicated
  sharding; gathers (triangle fetch, BVH nodes) stay device-local.  Primitive-sharded
  geometry for scenes past one device's memory is ``parallel/geometry.py`` (the
  real "TP" axis: per-device sub-BVHs, cross-shard hit min-reduce).
- **Gradient sync**: in the inverse-rendering train step, scene-parameter gradients
  are reduced over the mesh automatically by XLA (an all-reduce) because the
  parameters are replicated while the loss terms are ray-sharded.
- **Multi-host**: the same code runs under ``jax.distributed.initialize`` — the mesh
  then spans hosts and XLA routes the same collectives between them.

There is no token/sequence dimension in a ray tracer; the ray-grid sharding *is*
the context-parallel axis (SURVEY §5 long-context row).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.whitted import make_backend, render_image
from ..scene.types import Camera, Scene
from ..utils.config import RenderConfig

RAY_AXIS = "rays"
SAMPLE_AXIS = "samples"


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over the ray axis (rows of the pixel grid).  A flat
    device list: every GPU of a host reaches every other at the same rate."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def make_mesh2(ray_devices: int, sample_devices: int, devices=None) -> Mesh:
    """2-D mesh ('rays', 'samples'): pixel rows over one axis, soft-shadow
    samples over the other — the framework's sample/sequence-parallel axis
    (SURVEY §5 long-context row).  Useful when the per-hit sample count (200
    shadow rays in the reference workload) is the dominant dimension."""
    if devices is None:
        devices = jax.devices()
    n = ray_devices * sample_devices
    return Mesh(np.asarray(devices[:n]).reshape(ray_devices, sample_devices),
                (RAY_AXIS, SAMPLE_AXIS))


def sample_constraint(mesh: Mesh):
    """Constraint callable for the per-chunk [C, N, 3] soft-shadow sample batch
    (ops/shading.py::direct_spherical_lights): chunk samples split over the
    'samples' mesh axis, rays over 'rays'; XLA reduces the visibility counts
    across the sample axis at the sharded->unsharded boundary."""
    spec = NamedSharding(mesh, P(SAMPLE_AXIS, RAY_AXIS, None))

    def constrain(units):
        return jax.lax.with_sharding_constraint(units, spec)

    return constrain


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (image-row / flattened-ray) axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def _constrain_rows(x, mesh: Mesh):
    return jax.lax.with_sharding_constraint(x, row_sharded(mesh))


def sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                   key=None, bvh=None):
    """Jitted render with the pixel grid sharded over the mesh.

    The image rows are constrained to ``P('rays')``; XLA propagates the sharding
    backward through shading/intersection to the ray generation, so each device
    traces only its rows.  Scene/BVH stay replicated.
    """
    if key is None:
        key = jax.random.PRNGKey(0)

    @jax.jit
    def fn(scene_, camera_, bvh_, key_):
        backend = make_backend(scene_, cfg, bvh=bvh_, mesh=mesh)
        img = render_image(scene_, camera_, cfg, backend=backend, key=key_)
        return _constrain_rows(img, mesh)

    rep = replicated(mesh)
    scene_r = jax.device_put(scene, rep)
    camera_r = jax.device_put(camera, rep)
    bvh_r = jax.device_put(bvh, rep) if bvh is not None else None
    with mesh:
        return fn(scene_r, camera_r, bvh_r, key)


def sample_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                          mesh: Mesh, key=None, bvh=None):
    """Jitted render on a 2-D ('rays', 'samples') mesh: image rows sharded over
    'rays', soft-shadow sample chunks over 'samples'.

    Each device traces its row slice's primary/shadow structure but only its
    slice of the stochastic sample axis; XLA inserts the visibility-count
    reduction across 'samples' (a psum).  Bitwise-identical to the
    unsharded render because the per-(light, chunk) PRNG keys don't depend on
    the mesh (SURVEY §7 hard-part 4).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    constrain = sample_constraint(mesh)

    @jax.jit
    def fn(scene_, camera_, bvh_, key_):
        backend = make_backend(scene_, cfg, bvh=bvh_, mesh=mesh)
        img = render_image(scene_, camera_, cfg, backend=backend, key=key_,
                           sample_constrain=constrain)
        return _constrain_rows(img, mesh)

    rep = replicated(mesh)
    scene_r = jax.device_put(scene, rep)
    camera_r = jax.device_put(camera, rep)
    bvh_r = jax.device_put(bvh, rep) if bvh is not None else None
    with mesh:
        return fn(scene_r, camera_r, bvh_r, key)


def render_loss(params, scene: Scene, camera: Camera, target, cfg: RenderConfig,
                key, apply_params, mesh: Optional[Mesh] = None, bvh=None,
                refit_plan=None):
    """L2 image loss for inverse rendering: || render(scene <- params) - target ||^2.

    ``apply_params(scene, params) -> scene`` injects the optimizable leaves
    (materials, lights, vertices) into the scene pytree.  ``refit_plan``
    (ops/refit.py::make_refit_plan): when vertices are among the optimized
    params, the acceleration structure's AABBs + triangle tables are refit
    from the CURRENT vertices inside the loss, so BVH backends stay
    valid as geometry moves (without it the accel goes stale and only the
    brute backend is safe).
    """
    scene_p = apply_params(scene, params)
    if refit_plan is not None and bvh is not None:
        from ..ops.refit import refit_accel

        bvh = refit_accel(bvh, scene_p, refit_plan)
    backend = make_backend(scene_p, cfg, bvh=bvh, mesh=mesh)
    img = render_image(scene_p, camera, cfg, backend=backend, key=key)
    if mesh is not None:
        img = _constrain_rows(img, mesh)
        target = _constrain_rows(target, mesh)
    return jnp.mean((img - target) ** 2)


def make_train_step(cfg: RenderConfig, optimizer, apply_params,
                    mesh: Optional[Mesh] = None, bvh=None, refit_plan=None):
    """Build the jitted inverse-rendering train step.

    With a mesh, the target image and the rendered image are ray-sharded while
    ``params`` are replicated — XLA inserts the gradient all-reduce
    at the sharded->replicated boundary of the backward pass, overlapped with the
    backward sweep by the scheduler.  This is the framework's "gradient sync"
    (SURVEY §5 distributed-backend row).
    """

    def step(params, opt_state, scene, camera, target, key):
        loss, grads = jax.value_and_grad(render_loss)(
            params, scene, camera, target, cfg, key, apply_params, mesh=mesh,
            bvh=bvh, refit_plan=refit_plan,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def make_train_loop(cfg: RenderConfig, optimizer, apply_params,
                    steps_per_call: int, mesh: Optional[Mesh] = None, bvh=None,
                    refit_plan=None):
    """K optimizer steps per jitted dispatch (VERDICT r1 weak #8).

    A per-step dispatch pays the fixed per-call cost and a host sync every
    step; scanning K steps inside one call pays them once per K steps.
    ``params``/``opt_state`` are donated, so the optimizer state updates in
    place instead of allocating per step.

    Step j inside a call uses ``fold_in(key, start_step + j)`` — the same
    stream as K calls of ``make_train_step`` with ``fold_in(key, i)``, so
    per-step and scanned runs produce identical losses.

    Returns ``loop(params, opt_state, scene, camera, target, key, start_step)
    -> (params, opt_state, losses [K])``.
    """

    def k_steps(params, opt_state, scene, camera, target, key, start_step):
        def one(carry, j):
            params_, opt_state_ = carry
            skey = jax.random.fold_in(key, start_step + j)
            loss, grads = jax.value_and_grad(render_loss)(
                params_, scene, camera, target, cfg, skey, apply_params,
                mesh=mesh, bvh=bvh, refit_plan=refit_plan,
            )
            updates, opt_state_ = optimizer.update(grads, opt_state_, params_)
            params_ = jax.tree.map(lambda p, u: p + u, params_, updates)
            return (params_, opt_state_), loss

        (params, opt_state), losses = jax.lax.scan(
            one, (params, opt_state), jnp.arange(steps_per_call))
        return params, opt_state, losses

    return jax.jit(k_steps, donate_argnums=(0, 1))
