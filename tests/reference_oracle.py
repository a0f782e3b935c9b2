"""Independent numpy implementation of the REFERENCE's rendering algorithm.

This is the pixel-parity oracle (VERDICT r1 item 1): a from-scratch numpy
transcription of the reference's published *semantics* — NOT of our JAX
renderer's design — so agreement between the two is evidence that the JAX
framework reproduces the reference's output, not merely itself.

Deliberately uses the reference's algorithm where ours differs:
- triangle intersection = plane test + half-space inside-test + area-ratio
  barycentrics (src/ray_tracing.cpp:13-114), NOT
  Moller-Trumbore;
- closest-hit = in-order primitive sweep with ray.t as the running bound and
  ``t >= ray.t`` rejection (ray_tracing.cpp:64-67, 148-151);
- recursion: trace/shade with the depth-2 cap, miss->black, the comma-operator
  ks cutoff (only ks.z tested), eps=0.001 offsets
  (src/main.cpp:160-310);
- hard shadows per pointInShadow: closest hit from the eps-offset origin,
  blocked iff hit and t + eps < |light - point| (main.cpp:104-135);
- soft shadows: per spherical light, diffuse/specular w.r.t. the light CENTER
  scaled by the fraction of N Gaussian-normalized sample points reached
  (main.cpp:166-218; the reference's std::random_device stream is not
  reproducible, so the oracle draws its own Gaussians — comparisons are
  statistical);
- camera: glm quat-from-euler, position = lookAt + q*(0,0,-dist), direction =
  q * normalize(-px*halfW, py*halfH, 1), pixel-corner NDC, setPixel y-flip
  (framework/src/trackball.cpp:70-103, src/main.cpp:690-693, screen.cpp:34).

Everything is float32 to mirror glm.
"""
from __future__ import annotations

import numpy as np

F = np.float32
EPS = F(0.001)  # the reference's shadow/reflection offset (main.cpp:110,255)
MAX_LEVEL = 2   # trace() cap (main.cpp:267)


# --- camera (framework/src/trackball.cpp) ----------------------------------

def quat_from_euler(e):
    """glm::quat(vec3) component formula."""
    half = np.asarray(e, F) * F(0.5)
    cx, cy, cz = np.cos(half)
    sx, sy, sz = np.sin(half)
    return np.array([
        cx * cy * cz + sx * sy * sz,
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
    ], F)


def quat_rotate(q, v):
    w, u = q[0], q[1:]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv + w * v)
    return (v + 2.0 * uuv).astype(F)


def camera_rays(look_at, euler, dist, fovy, aspect, height, width):
    """[H*W, 3] origins/dirs in image-row order (row 0 = top), matching the
    y-flip convention (screen.cpp:34) and pixel-corner NDC (main.cpp:690-693)."""
    q = quat_from_euler(euler)
    origin = np.asarray(look_at, F) + quat_rotate(q, np.array([0, 0, -dist], F))
    half_h = np.tan(F(fovy) / 2, dtype=F)
    half_w = F(aspect) * half_h
    xs = (np.arange(width, dtype=F)) / F(width) * 2 - 1
    ys = (np.arange(height - 1, -1, -1, dtype=F)) / F(height) * 2 - 1
    px, py = np.meshgrid(xs, ys)
    cam_dir = np.stack([-px * half_w, py * half_h, np.ones_like(px)], -1)
    cam_dir /= np.linalg.norm(cam_dir, axis=-1, keepdims=True)
    dirs = (cam_dir.reshape(-1, 3) + 2.0 * np.cross(
        q[1:], np.cross(q[1:], cam_dir.reshape(-1, 3)) + q[0] * cam_dir.reshape(-1, 3)
    )).astype(F)
    origins = np.broadcast_to(origin, dirs.shape).astype(F)
    return origins, dirs


# --- scene extraction -------------------------------------------------------

class OracleScene:
    """Numpy copy of a cg_raytracer Scene with per-triangle materials."""

    def __init__(self, scene):
        self.v = np.asarray(scene.vertices, F)
        self.n = np.asarray(scene.normals, F)
        self.tris = np.asarray(scene.triangles, np.int64)
        tm = np.asarray(scene.tri_material, np.int64)
        self.kd = np.asarray(scene.materials.kd, F)[tm]
        self.ks = np.asarray(scene.materials.ks, F)[tm]
        self.shin = np.asarray(scene.materials.shininess, F)[tm]
        self.sph_c = np.asarray(scene.spheres.center, F)
        self.sph_r = np.asarray(scene.spheres.radius, F)
        self.sph_kd = np.asarray(scene.spheres.kd, F)
        self.sph_ks = np.asarray(scene.spheres.ks, F)
        self.sph_shin = np.asarray(scene.spheres.shininess, F)
        self.plights = [(np.asarray(p, F), np.asarray(c, F)) for p, c in
                        zip(np.asarray(scene.point_lights.position, F),
                            np.asarray(scene.point_lights.color, F))]
        self.slights = [(np.asarray(p, F), F(r), np.asarray(c, F)) for p, r, c in
                        zip(np.asarray(scene.spherical_lights.position, F),
                            np.asarray(scene.spherical_lights.radius, F),
                            np.asarray(scene.spherical_lights.color, F))]


# --- closest hit (ray_tracing.cpp semantics) --------------------------------

def closest_hit(sc: OracleScene, o, d):
    """In-order sweep over triangles then spheres, ray.t as running bound.

    Returns (t, hit, normal, kd, ks, shin) vectorized over rays."""
    n_rays = o.shape[0]
    t = np.full(n_rays, np.finfo(F).max, F)  # ray.t starts at FLT_MAX
    hit = np.zeros(n_rays, bool)
    normal = np.zeros((n_rays, 3), F)
    kd = np.zeros((n_rays, 3), F)
    ks = np.zeros((n_rays, 3), F)
    shin = np.ones(n_rays, F)

    for ti in range(sc.tris.shape[0]):
        i0, i1, i2 = sc.tris[ti]
        v0, v1, v2 = sc.v[i0], sc.v[i1], sc.v[i2]
        pn = np.cross(v1 - v0, v2 - v0)
        pn = (pn / np.linalg.norm(pn)).astype(F)  # trianglePlane (:74-82)
        D = F(np.dot(v0, pn))
        denom = d @ pn
        num = D - o @ pn
        on_plane = num == 0.0  # origin in plane -> t = 0 (:42-46)
        with np.errstate(divide="ignore", invalid="ignore"):
            t_cand = np.where(denom != 0.0, num / denom, F(-1.0))
        t_cand = np.where(on_plane, F(0.0), t_cand).astype(F)
        ok = (on_plane | ((denom != 0.0) & (t_cand >= 0.0))) & (t_cand < t)

        if not ok.any():
            continue
        p = o + d * t_cand[:, None]
        # pointInTriangle half-space tests, edge-inclusive >= 0 (:23-37)
        inside = (
            (np.einsum("j,ij->i", pn, np.cross(v1 - v0, p - v0)) >= 0)
            & (np.einsum("j,ij->i", pn, np.cross(v2 - v1, p - v1)) >= 0)
            & (np.einsum("j,ij->i", pn, np.cross(v0 - v2, p - v2)) >= 0)
        )
        ok &= inside
        if not ok.any():
            continue
        # Area-ratio barycentrics (:92-97): alpha weights v0's normal, etc.
        area = F(0.5) * np.linalg.norm(np.cross(v1 - v0, v2 - v0))
        a = 0.5 * np.linalg.norm(np.cross(v1 - p, v2 - p), axis=-1) / area
        b = 0.5 * np.linalg.norm(np.cross(v0 - p, v2 - p), axis=-1) / area
        g = 0.5 * np.linalg.norm(np.cross(v0 - p, v1 - p), axis=-1) / area
        ninterp = (a[:, None] * sc.n[i0] + b[:, None] * sc.n[i1]
                   + g[:, None] * sc.n[i2]).astype(F)
        ninterp /= np.maximum(np.linalg.norm(ninterp, axis=-1, keepdims=True),
                              1e-20)
        # Camera-facing flip on the PLANE normal's sign (:99-106).
        facing = (np.einsum("j,ij->i", pn, -d) > 0)
        ninterp = np.where(facing[:, None], ninterp, -ninterp)

        t = np.where(ok, t_cand, t)
        hit |= ok
        normal = np.where(ok[:, None], ninterp, normal)
        kd = np.where(ok[:, None], sc.kd[ti], kd)
        ks = np.where(ok[:, None], sc.ks[ti], ks)
        shin = np.where(ok, sc.shin[ti], shin)

    for si in range(sc.sph_c.shape[0]):
        c, r = sc.sph_c[si], sc.sph_r[si]
        oc = o - c
        a_ = np.einsum("ij,ij->i", d, d)
        b_ = 2 * np.einsum("ij,ij->i", d, oc)
        c_ = np.einsum("ij,ij->i", oc, oc) - r * r
        disc = b_ * b_ - 4 * a_ * c_
        sq = np.sqrt(np.maximum(disc, 0))
        smaller = (-b_ - sq) / (2 * a_)
        bigger = (-b_ + sq) / (2 * a_)
        t_cand = np.where(smaller >= 0, smaller, bigger).astype(F)
        ok = (disc >= 0) & (t_cand >= 0) & (t_cand < t)
        p = o + d * t_cand[:, None]
        nsp = (p - c)
        nsp /= np.maximum(np.linalg.norm(nsp, axis=-1, keepdims=True), 1e-20)
        t = np.where(ok, t_cand, t)
        hit |= ok
        normal = np.where(ok[:, None], nsp.astype(F), normal)
        kd = np.where(ok[:, None], sc.sph_kd[si], kd)
        ks = np.where(ok[:, None], sc.sph_ks[si], ks)
        shin = np.where(ok, sc.sph_shin[si], shin)

    return t, hit, normal, kd, ks, shin


# --- shading (main.cpp:46-235) ----------------------------------------------

def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _reflect(d, n):
    return d - 2.0 * np.einsum("ij,ij->i", d, n)[:, None] * n


def _phong(d, normal, kd, ks, shin, ldir, lcol):
    """diffuseOneLight + specularOneLight (main.cpp:61-98)."""
    dcos = np.einsum("ij,ij->i", ldir, normal)
    diffuse = lcol * kd * np.maximum(dcos, 0)[:, None]
    refl = _normalize(_reflect(d, normal))
    scos = np.einsum("ij,ij->i", refl, ldir)
    spec = np.where(scos > 0, np.power(np.maximum(scos, 1e-30), shin), 0)
    return diffuse + lcol * ks * spec[:, None]


def shading(sc, o, d, t, hit, normal, kd, ks, shin, rng, num_samples):
    point = o + d * np.where(hit, t, 0)[:, None]
    result = np.zeros_like(point)

    for lpos, lrad, lcol in sc.slights:
        ldir = _normalize(lpos - point)
        phong = _phong(d, normal, kd, ks, shin, ldir, lcol)
        counter = np.zeros(point.shape[0], F)
        for _ in range(num_samples):
            gauss = rng.standard_normal(3).astype(F)
            sample = lpos + lrad * (gauss / np.linalg.norm(gauss)).astype(F)
            sdir = _normalize(sample - point)
            sorigin = point + EPS * sdir
            light_t = np.linalg.norm(sample - sorigin, axis=-1)
            ts, hs, *_ = closest_hit(sc, sorigin, sdir)
            counter += (~hs) | (ts > light_t)  # main.cpp:183-196
        result += phong * (counter / F(num_samples))[:, None]

    for lpos, lcol in sc.plights:
        to_light = lpos - point
        dist = np.linalg.norm(to_light, axis=-1)
        ldir = _normalize(to_light)
        sorigin = point + EPS * ldir  # pointInShadow offset (main.cpp:110-111)
        ts, hs, *_ = closest_hit(sc, sorigin, ldir)
        blocked = hs & (ts + EPS < dist)  # visibility test (main.cpp:119)
        phong = _phong(d, normal, kd, ks, shin, ldir, lcol)
        result += phong * (~blocked)[:, None]

    return result * hit[:, None]


def trace(sc, o, d, level, rng, num_samples):
    """trace/shade recursion (main.cpp:160-310), vectorized over rays."""
    n_rays = o.shape[0]
    if level >= MAX_LEVEL:
        return np.zeros((n_rays, 3), F)
    t, hit, normal, kd, ks, shin = closest_hit(sc, o, d)
    direct = shading(sc, o, d, t, hit, normal, kd, ks, shin, rng, num_samples)
    # Comma-operator quirk: only ks.z is tested (main.cpp:246).
    reflective = hit & (ks[:, 2] > 0.01)
    color = direct
    if reflective.any():  # trace(level+1) itself returns black at the cap
        point = o + d * np.where(hit, t, 0)[:, None]
        refl = _normalize(_reflect(d, normal))
        ro = point + EPS * refl  # main.cpp:255-256
        rcolor = trace(sc, ro, refl, level + 1, rng, num_samples)
        color = color + rcolor * ks * reflective[:, None]
    return color * hit[:, None]  # miss -> black (main.cpp:289-294)


def render_reference(scene, height, width, look_at=(0, 0, 0),
                     euler_deg=(20.0, 20.0, 0.0), dist=3.0, fovy_deg=50.0,
                     aspect=None, num_soft_samples=0, seed=0):
    """Full oracle render -> [H, W, 3] float32 (no AA/bloom/blur)."""
    sc = OracleScene(scene)
    if aspect is None:
        aspect = width / height
    o, d = camera_rays(np.asarray(look_at, F),
                       np.radians(np.asarray(euler_deg, np.float64)).astype(F),
                       F(dist), F(np.radians(fovy_deg)), F(aspect),
                       height, width)
    rng = np.random.default_rng(seed)
    img = trace(sc, o, d, 0, rng, num_soft_samples)
    return img.reshape(height, width, 3)
