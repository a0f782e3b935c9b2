"""Post-process effects: anti-aliasing, bloom, motion blur.

Reference capability (``src/main.cpp``):
- AA: 2x2 supersampling per pixel (main.cpp:663-687).  The reference's subsample NDC
  works out to offsets {0, 1} in *half-pixel* units and divides the 4-sample sum by
  ``level * 2.5f = 5`` (a documented quirk that darkens the image, main.cpp:685);
  default mode divides by 4, ``reference_quirks`` reproduces /5.
- Bloom: brightness threshold (R+G+B > 1) then a 21x21 box blur added back over the
  base image (main.cpp:586-628, 698-705).  The reference's in-place accumulation
  contaminates later pixels with already-blurred earlier ones; default mode is the
  clean separable box filter (two 1-D convolutions — an HBM-friendly formulation),
  which is also what its cited GPU Gems reference describes.
- Motion blur: camera lookAt jittered along +x in steps of 0.01 for 15 extra renders,
  averaged with a /16 divisor (main.cpp:318-584).  The reference *omits* the base
  render from the sum but still divides by 16 (darkening quirk); default mode
  averages base + 15 jittered renders, ``reference_quirks`` drops the base render.

All three are pure jnp transforms of the render function — differentiable and free to
fuse with the main pass under jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene.types import Camera
from ..utils.config import RenderConfig

BLOOM_RADIUS = 10  # 21x21 window (main.cpp:594-600)
MOTION_BLUR_STEPS = 15
MOTION_BLUR_DELTA = 0.01


def supersample_render(render_offset_fn, cfg: RenderConfig):
    """2x2 supersampling: average 4 renders at half-pixel offsets.

    render_offset_fn((ox, oy) in pixel units) -> [H, W, 3].
    Subsample positions match main.cpp:666-672: pixel corner + {0, 0.5} px.
    """
    offsets = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)]
    acc = None
    for off in offsets:
        img = render_offset_fn(off)
        acc = img if acc is None else acc + img
    divisor = 5.0 if cfg.reference_quirks else 4.0  # main.cpp:685 quirk
    return acc / divisor


def _box_blur_1d(img, radius: int, axis: int):
    """Mean filter along one axis with edge-clipped normalization (zero padding +
    count normalization, matching the reference's boundary ``continue`` skips)."""
    size = 2 * radius + 1
    ones = jnp.ones_like(img[..., :1])
    kernel = jnp.ones((size,), img.dtype)

    def conv1d(x):
        # x: [..., L] along `axis` moved to the end
        moved = jnp.moveaxis(x, axis, -1)
        shape = moved.shape
        flat = moved.reshape(-1, 1, shape[-1])
        out = jax.lax.conv_general_dilated(
            flat, kernel.reshape(1, 1, size),
            window_strides=(1,), padding=[(radius, radius)],
            dimension_numbers=("NCH", "IOH", "NCH"),
        )
        return jnp.moveaxis(out.reshape(shape), -1, axis)

    summed = conv1d(img)
    counts = conv1d(jnp.broadcast_to(ones, img.shape))
    return summed / counts


def bloom(img, cfg: RenderConfig):
    """Threshold + 21x21 box blur + add-back (bloomEffect, main.cpp:586-628).

    Default mode: clean separable box filter.  ``reference_quirks``: the
    reference's in-place raster-scan accumulation (see ``_bloom_quirk``).
    """
    if cfg.reference_quirks:
        return _bloom_quirk(img)
    bright = jnp.where(jnp.sum(img, axis=-1, keepdims=True) > 1.0, img, 0.0)
    blurred = _box_blur_1d(_box_blur_1d(bright, BLOOM_RADIUS, axis=0), BLOOM_RADIUS, axis=1)
    return img + blurred


def _bloom_quirk(img):
    """The reference's bloom, bug-for-bug (bloomEffect, main.cpp:586-628).

    The reference blurs its thresholded buffer **in place** while scanning
    pixels in row-major order: for each pixel it averages the current buffer
    over the in-bounds 21x21 window (center's own — still raw — value included
    via the loop's ``counter = 1`` start), writing the mean back into the
    buffer.  Pixels above/left therefore contribute already-blurred values and
    pixels below/right raw thresholded ones — a directional smear the clean
    separable filter does not reproduce.  The final pixel adds a fresh
    ``getFinalColor`` (main.cpp:623), which equals the base render for
    deterministic scenes.

    The in-place data dependence is inherently sequential, so this is a
    row/column ``lax.scan`` over pixels — O(H*W) steps of a 21x21 window mean.
    It exists for pixel parity, not speed.  The AA-path threshold variant
    (main.cpp:676-682) is ``bloom_quirk_aa`` below.
    """
    bright = jnp.where(jnp.sum(img, axis=-1, keepdims=True) > 1.0, img, 0.0)
    return img + _bloom_quirk_blur(bright)


def bloom_quirk_aa(render_offset_fn, cfg: RenderConfig):
    """The reference's bloom on the *AA path*, bug-for-bug (main.cpp:663-705).

    With anti-aliasing on, the reference's per-subsample bloom block overwrites
    the bright buffer every subsample, so only the LAST (x+0.5, y+0.5)
    subsample's write survives — gated on the *running 4-subsample sum*
    (undivided, so effectively ``sum4 > 1`` where the displayed AA value is
    ``sum4/5``), storing that last subsample's color (main.cpp:676-682).
    ``bloomEffect`` then in-place-blurs that buffer and its final ``setPixel``
    REPLACES the anti-aliased pixel with ``blurred + getFinalColor(center
    ray)`` — an un-antialiased base (main.cpp:616-624), i.e. AA affects the
    output only through the threshold test.

    ``render_offset_fn((ox, oy) in pixel units) -> [H, W, 3]``, matching
    ``supersample_render``'s offset convention.
    """
    offsets = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5)]
    imgs = [render_offset_fn(off) for off in offsets]
    total = imgs[0] + imgs[1] + imgs[2] + imgs[3]
    # Subsample loop order is y then x, so (0.5, 0.5) is written last.
    bright = jnp.where(jnp.sum(total, axis=-1, keepdims=True) > 1.0, imgs[3], 0.0)
    return imgs[0] + _bloom_quirk_blur(bright)


def _bloom_quirk_blur(bright):
    """The reference's sequential in-place 21x21 window mean (main.cpp:586-614)."""
    h, w = bright.shape[0], bright.shape[1]
    r = BLOOM_RADIUS
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    # In-bounds window size per pixel (center included): the reference's
    # ``counter`` (1 + #in-bounds non-center neighbors, main.cpp:590-614).
    cnt_y = jnp.minimum(ys + r, h - 1) - jnp.maximum(ys - r, 0) + 1
    cnt_x = jnp.minimum(xs + r, w - 1) - jnp.maximum(xs - r, 0) + 1
    counter = (cnt_y[:, None] * cnt_x[None, :]).astype(jnp.float32)
    buf = jnp.pad(bright, ((r, r), (r, r), (0, 0)))

    def one_row(buf, y):
        def one_col(buf, x):
            win = jax.lax.dynamic_slice(buf, (y, x, 0), (2 * r + 1, 2 * r + 1, 3))
            mean = jnp.sum(win, axis=(0, 1)) / counter[y, x]
            buf = jax.lax.dynamic_update_slice(buf, mean[None, None, :],
                                               (y + r, x + r, 0))
            return buf, None

        buf, _ = jax.lax.scan(one_col, buf, xs)
        return buf, None

    buf, _ = jax.lax.scan(one_row, buf, ys)
    return buf[r:r + h, r:r + w]


def motion_blur(base_render_fn, camera: Camera, cfg: RenderConfig, key):
    """Average over lookAt-jittered cameras (blurEffect, main.cpp:318-584).

    base_render_fn(camera, key) -> [H, W, 3].  Uses lax.map over the camera stack to
    keep peak memory at one render at a time.
    """
    deltas = jnp.arange(1, MOTION_BLUR_STEPS + 1, dtype=jnp.float32) * MOTION_BLUR_DELTA
    offsets = jnp.stack([deltas, jnp.zeros_like(deltas), jnp.zeros_like(deltas)],
                        axis=-1)  # [15, 3] — +x jitter steps of 0.01
    if cfg.reference_quirks:
        # The reference sets lookAt to the ABSOLUTE points (0.01*i, 0, 0)
        # regardless of the user's camera (main.cpp:344-568) — a non-default
        # camera teleports to the origin.  Default mode jitters relative to
        # the actual camera target instead.
        look_ats = offsets
    else:
        look_ats = camera.look_at[None, :] + offsets

    def one(look_at):
        cam_i = Camera(look_at=look_at, euler=camera.euler, dist=camera.dist,
                       fovy=camera.fovy, aspect=camera.aspect)
        return base_render_fn(cam_i, key)

    jittered_sum = jnp.sum(jax.lax.map(one, look_ats), axis=0)
    if cfg.reference_quirks:
        # The reference omits the base render but divides by 16 (main.cpp:581).
        return jittered_sum / 16.0
    base = base_render_fn(camera, key)
    return (base + jittered_sum) / float(MOTION_BLUR_STEPS + 1)
