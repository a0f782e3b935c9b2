"""Scene data model: SoA pytrees for an accelerator-friendly layout.

Reference capability: the C++ AoS scene model (``src/scene.h:26-60``,
``src/mesh.h:12-35``) stores per-mesh vertex/triangle vectors with one
``Material`` per mesh.  This design flattens every mesh into one global
structure-of-arrays buffer: ``vertices [V,3]``, ``normals [V,3]``, ``triangles [T,3]``
plus a per-triangle material id into a compact material table.  This gives static
shapes XLA can tile, one gather per hit instead of pointer chasing, and a single
buffer the BVH can reorder.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


def _register(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), None

    def unflatten(_, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register
@dataclasses.dataclass
class Materials:
    """Compact material table (reference ``Material``, mesh.h:17-23).

    ``kd``: [M,3] diffuse, ``ks``: [M,3] specular, ``shininess``: [M],
    ``transparency``: [M] (parsed and carried, unused in shading — parity with the
    reference, which reads opacity but never applies it).
    """

    kd: Array
    ks: Array
    shininess: Array
    transparency: Array

    @staticmethod
    def single(kd=(1.0, 1.0, 1.0), ks=(0.0, 0.0, 0.0), shininess=1.0, transparency=1.0):
        return Materials(
            kd=jnp.asarray([kd], jnp.float32),
            ks=jnp.asarray([ks], jnp.float32),
            shininess=jnp.asarray([shininess], jnp.float32),
            transparency=jnp.asarray([transparency], jnp.float32),
        )


@_register
@dataclasses.dataclass
class PointLights:
    """Reference ``PointLight`` (scene.h:42-45), batched."""

    position: Array  # [L,3]
    color: Array  # [L,3]

    @staticmethod
    def empty():
        z = jnp.zeros((0, 3), jnp.float32)
        return PointLights(position=z, color=z)

    @staticmethod
    def of(*lights):
        pos = jnp.asarray([p for p, _ in lights], jnp.float32).reshape(-1, 3)
        col = jnp.asarray([c for _, c in lights], jnp.float32).reshape(-1, 3)
        return PointLights(position=pos, color=col)


@_register
@dataclasses.dataclass
class SphericalLights:
    """Reference ``SphericalLight`` (scene.h:47-51), batched."""

    position: Array  # [L,3]
    radius: Array  # [L]
    color: Array  # [L,3]

    @staticmethod
    def empty():
        z3 = jnp.zeros((0, 3), jnp.float32)
        return SphericalLights(position=z3, radius=jnp.zeros((0,), jnp.float32), color=z3)

    @staticmethod
    def of(*lights):
        pos = jnp.asarray([p for p, _, _ in lights], jnp.float32).reshape(-1, 3)
        rad = jnp.asarray([r for _, r, _ in lights], jnp.float32).reshape(-1)
        col = jnp.asarray([c for _, _, c in lights], jnp.float32).reshape(-1, 3)
        return SphericalLights(position=pos, radius=rad, color=col)


@_register
@dataclasses.dataclass
class Spheres:
    """Reference ``Sphere`` primitives (scene.h:36-40), batched, with inline materials."""

    center: Array  # [S,3]
    radius: Array  # [S]
    kd: Array  # [S,3]
    ks: Array  # [S,3]
    shininess: Array  # [S]

    @staticmethod
    def empty():
        z3 = jnp.zeros((0, 3), jnp.float32)
        z1 = jnp.zeros((0,), jnp.float32)
        return Spheres(center=z3, radius=z1, kd=z3, ks=z3, shininess=z1)


@_register
@dataclasses.dataclass
class Scene:
    """Flattened scene: all meshes merged into global SoA buffers.

    Replaces ``Scene{meshes, spheres, pointLights, sphericalLight}``
    (``src/scene.h:53-60``).  Triangle vertex indices point into the
    global vertex buffer; ``tri_material`` maps each triangle to a row of
    ``materials``.
    """

    vertices: Array  # [V,3] f32
    normals: Array  # [V,3] f32 (vertex normals)
    triangles: Array  # [T,3] i32
    tri_material: Array  # [T] i32
    materials: Materials
    spheres: Spheres
    point_lights: PointLights
    spherical_lights: SphericalLights

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


@_register
@dataclasses.dataclass
class Camera:
    """Trackball camera pytree (reference ``Trackball``, framework/src/trackball.cpp).

    ``look_at``: [3], ``euler``: [3] radians (glm::quat Euler convention),
    ``dist``: scalar, ``fovy``: scalar radians, ``aspect``: scalar.
    Defaults match main.cpp:730-731: fovy 50 deg, dist 3, rotation (20, 20, 0) deg.
    """

    look_at: Array
    euler: Array
    dist: Array
    fovy: Array
    aspect: Array

    @staticmethod
    def default(look_at=(0.0, 0.0, 0.0), euler_deg=(20.0, 20.0, 0.0), dist=3.0,
                fovy_deg=50.0, aspect=1.0):
        return Camera(
            look_at=jnp.asarray(look_at, jnp.float32),
            euler=jnp.asarray(np.radians(np.asarray(euler_deg, np.float64)), jnp.float32),
            dist=jnp.asarray(dist, jnp.float32),
            fovy=jnp.asarray(np.radians(fovy_deg), jnp.float32),
            aspect=jnp.asarray(aspect, jnp.float32),
        )


def merge_meshes(meshes):
    """Flatten a list of (vertices, normals, triangles, material_dict) into a Scene-ready
    tuple of numpy arrays.  Mirrors how the reference iterates ``scene.meshes``
    (bvh.cpp:850-881) but produces one global buffer instead.

    Each element: dict with keys 'vertices' [V,3], 'normals' [V,3], 'triangles' [T,3],
    'material': dict(kd, ks, shininess, transparency).
    """
    verts, norms, tris, tri_mat = [], [], [], []
    kd, ks, shin, trans = [], [], [], []
    v_off = 0
    for mi, m in enumerate(meshes):
        v = np.asarray(m["vertices"], np.float32)
        n = np.asarray(m["normals"], np.float32)
        t = np.asarray(m["triangles"], np.int32)
        verts.append(v)
        norms.append(n)
        tris.append(t + v_off)
        tri_mat.append(np.full((t.shape[0],), mi, np.int32))
        mat = m["material"]
        kd.append(mat.get("kd", (1.0, 1.0, 1.0)))
        ks.append(mat.get("ks", (0.0, 0.0, 0.0)))
        shin.append(mat.get("shininess", 1.0))
        trans.append(mat.get("transparency", 1.0))
        v_off += v.shape[0]
    if not meshes:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32),
                Materials.single())
    materials = Materials(
        kd=jnp.asarray(np.asarray(kd, np.float32)),
        ks=jnp.asarray(np.asarray(ks, np.float32)),
        shininess=jnp.asarray(np.asarray(shin, np.float32)),
        transparency=jnp.asarray(np.asarray(trans, np.float32)),
    )
    return (np.concatenate(verts), np.concatenate(norms), np.concatenate(tris),
            np.concatenate(tri_mat), materials)


def make_scene(meshes=(), spheres=None, point_lights=None, spherical_lights=None) -> Scene:
    """Build a Scene pytree from loaded mesh dicts + light specs."""
    v, n, t, tm, materials = merge_meshes(list(meshes))
    return Scene(
        vertices=jnp.asarray(v),
        normals=jnp.asarray(n),
        triangles=jnp.asarray(t),
        tri_material=jnp.asarray(tm),
        materials=materials,
        spheres=spheres if spheres is not None else Spheres.empty(),
        point_lights=point_lights if point_lights is not None else PointLights.empty(),
        spherical_lights=spherical_lights if spherical_lights is not None else SphericalLights.empty(),
    )
