"""cg_raytracer: a differentiable Whitted ray tracer in JAX.

A framework with the capabilities of the reference C++ tracer
(mgokbulut/CG-RayTracer), built for accelerators: pure-functional jitted render
pipeline, SoA scene pytrees, flattened-BVH closest-hit/any-hit oracles (a
per-ray CUDA traversal kernel on NVIDIA GPUs), pixel-grid sharding over device
meshes, and end-to-end gradients from pixels to scene parameters.
"""

from .models.whitted import render, render_image, make_backend, trace_rays
from .ops.bvh import BVH, build_bvh
from .ops.camera import generate_ray, generate_rays
from .scene.presets import SCENE_NAMES, load_scene
from .scene.types import Camera, Materials, PointLights, Scene, SphericalLights, Spheres, make_scene
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "render",
    "render_image",
    "make_backend",
    "trace_rays",
    "BVH",
    "build_bvh",
    "generate_ray",
    "generate_rays",
    "SCENE_NAMES",
    "load_scene",
    "Camera",
    "Materials",
    "PointLights",
    "Scene",
    "SphericalLights",
    "Spheres",
    "make_scene",
    "RenderConfig",
    "__version__",
]
