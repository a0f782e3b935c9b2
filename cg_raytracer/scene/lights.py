"""Light editing: the headless equivalent of the reference's ImGui light editor.

Reference capability (``src/main.cpp:812-876``): a "Selected
light" combo over the unified list [point lights..., spherical lights...], drag
widgets for position/color (+ radius for spherical lights), and Add point light
(position 0, color 1), Add spherical light (position 0, radius 0.1, color 1),
Remove selected light buttons.

Every editor action is a pure function Scene -> Scene here; the unified index
convention (point lights first, then spherical) matches the reference's combo
ordering, so a scripted sequence of edits reproduces an interactive session.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .types import PointLights, Scene, SphericalLights

# Reference defaults for newly added lights (main.cpp:856-864).
DEFAULT_POSITION = (0.0, 0.0, 0.0)
DEFAULT_COLOR = (1.0, 1.0, 1.0)
DEFAULT_RADIUS = 0.1


def num_lights(scene: Scene) -> int:
    """Total editable lights (point + spherical), the combo length."""
    return (scene.point_lights.position.shape[0]
            + scene.spherical_lights.position.shape[0])


def _split_index(scene: Scene, index: int):
    """Unified index -> ('point'|'spherical', local index); raises IndexError."""
    np_ = scene.point_lights.position.shape[0]
    ns = scene.spherical_lights.position.shape[0]
    if not (0 <= index < np_ + ns):
        raise IndexError(
            f"light index {index} out of range (scene has {np_} point + "
            f"{ns} spherical lights)"
        )
    return ("point", index) if index < np_ else ("spherical", index - np_)


def add_point_light(scene: Scene, position=DEFAULT_POSITION,
                    color=DEFAULT_COLOR) -> Scene:
    """Append a point light (Add point light button, main.cpp:856-860)."""
    pl = scene.point_lights
    return dataclasses.replace(
        scene,
        point_lights=PointLights(
            position=jnp.concatenate(
                [pl.position, jnp.asarray([position], jnp.float32)]),
            color=jnp.concatenate([pl.color, jnp.asarray([color], jnp.float32)]),
        ),
    )


def add_spherical_light(scene: Scene, position=DEFAULT_POSITION,
                        radius: float = DEFAULT_RADIUS,
                        color=DEFAULT_COLOR) -> Scene:
    """Append a spherical light (Add spherical light button, main.cpp:861-864)."""
    sl = scene.spherical_lights
    return dataclasses.replace(
        scene,
        spherical_lights=SphericalLights(
            position=jnp.concatenate(
                [sl.position, jnp.asarray([position], jnp.float32)]),
            radius=jnp.concatenate(
                [sl.radius, jnp.asarray([radius], jnp.float32).reshape(1)]),
            color=jnp.concatenate([sl.color, jnp.asarray([color], jnp.float32)]),
        ),
    )


def remove_light(scene: Scene, index: int) -> Scene:
    """Remove the light at the unified index (Remove selected light button,
    main.cpp:866-876)."""
    kind, li = _split_index(scene, index)
    if kind == "point":
        pl = scene.point_lights
        keep = np.arange(pl.position.shape[0]) != li
        return dataclasses.replace(
            scene, point_lights=PointLights(position=pl.position[keep],
                                            color=pl.color[keep]))
    sl = scene.spherical_lights
    keep = np.arange(sl.position.shape[0]) != li
    return dataclasses.replace(
        scene,
        spherical_lights=SphericalLights(position=sl.position[keep],
                                         radius=sl.radius[keep],
                                         color=sl.color[keep]))


def set_light(scene: Scene, index: int, position=None, color=None,
              radius: Optional[float] = None) -> Scene:
    """Edit the selected light's position/color (+ radius for spherical lights
    only, mirroring the editor's conditional radius widget, main.cpp:833-841)."""
    kind, li = _split_index(scene, index)
    if kind == "point":
        if radius is not None:
            raise ValueError(
                f"light {index} is a point light; radius applies only to "
                f"spherical lights"
            )
        pl = scene.point_lights
        pos = pl.position if position is None else pl.position.at[li].set(
            jnp.asarray(position, jnp.float32))
        col = pl.color if color is None else pl.color.at[li].set(
            jnp.asarray(color, jnp.float32))
        return dataclasses.replace(scene,
                                   point_lights=PointLights(position=pos, color=col))
    sl = scene.spherical_lights
    pos = sl.position if position is None else sl.position.at[li].set(
        jnp.asarray(position, jnp.float32))
    col = sl.color if color is None else sl.color.at[li].set(
        jnp.asarray(color, jnp.float32))
    rad = sl.radius if radius is None else sl.radius.at[li].set(
        jnp.float32(radius))
    return dataclasses.replace(
        scene,
        spherical_lights=SphericalLights(position=pos, radius=rad, color=col))


def apply_edits(scene: Scene, removes: Sequence[int] = (),
                add_points: Sequence[Sequence[float]] = (),
                add_sphericals: Sequence[Sequence[float]] = (),
                index: int = 0, position=None, color=None,
                radius: Optional[float] = None) -> Scene:
    """Scripted editor session: removes (sequentially, each re-indexing like
    repeated button presses), then adds, then an edit of the selected light.

    ``add_points`` entries: (x, y, z, r, g, b).
    ``add_sphericals`` entries: (x, y, z, radius, r, g, b).
    """
    for ri in removes:
        scene = remove_light(scene, int(ri))
    for spec in add_points:
        x, y, z, r_, g, b = (float(v) for v in spec)
        scene = add_point_light(scene, position=(x, y, z), color=(r_, g, b))
    for spec in add_sphericals:
        x, y, z, rad, r_, g, b = (float(v) for v in spec)
        scene = add_spherical_light(scene, position=(x, y, z), radius=rad,
                                    color=(r_, g, b))
    if position is not None or color is not None or radius is not None:
        scene = set_light(scene, index, position=position, color=color,
                          radius=radius)
    return scene
