"""Headless software renderer over the native C++ rasterizer.

Counterpart of ``brax_tracking_tpu/native/softraster.py`` without
``mujoco``: the geoms are tessellated once from a frozen model's render
fields (``physics/spec.py::render_fields``) in place of an ``MjModel``, and
``update_scene`` takes the frame's geom poses and camera frames as arrays
in place of an ``MjData`` (``harness/render.py`` computes them on the
card). Each frame's triangles go to world space on the host, with the same
float32 casts and ``einsum`` as the JAX renderer, and are scan-converted by
``native/csrc/rasterizer.cc`` (flat-shaded, z-buffered, multithreaded), so
the same poses give the same pixels.

MuJoCo camera convention: the camera looks along the -Z axis of its frame,
+X right, +Y up (mjModel documentation for mjCamera).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from brax_tracking_tpu_torch.native import load_library
from brax_tracking_tpu_torch.physics import model as M


# --- tessellation (unit primitives, scaled per geom) -----------------------


def _uv_sphere(n_lat: int = 8, n_lon: int = 12):
    verts, faces = [], []
    for i in range(n_lat + 1):
        th = math.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * math.pi * j / n_lon
            verts.append(
                (math.sin(th) * math.cos(ph), math.sin(th) * math.sin(ph), math.cos(th))
            )
    def vid(i, j):
        return i * n_lon + (j % n_lon)
    for i in range(n_lat):
        for j in range(n_lon):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            if i > 0:
                faces.append((a, b, d))
            if i < n_lat - 1:
                faces.append((b, c, d))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


_SPHERE_V, _SPHERE_F = _uv_sphere()


def _capsule(radius: float, half_len: float, n_lon: int = 12, n_lat: int = 4):
    # two hemispheres displaced by +-half_len along z, joined by a tube
    verts, faces = [], []
    rows = []
    for cap in (1, -1):  # top then bottom
        for i in range(n_lat + 1):
            th = (math.pi / 2) * i / n_lat if cap == 1 else (math.pi / 2) + (math.pi / 2) * i / n_lat
            row = []
            for j in range(n_lon):
                ph = 2 * math.pi * j / n_lon
                x = radius * math.sin(th) * math.cos(ph)
                y = radius * math.sin(th) * math.sin(ph)
                z = radius * math.cos(th) + (half_len if cap == 1 else -half_len)
                row.append(len(verts))
                verts.append((x, y, z))
            rows.append(row)
    # skip duplicate equator row between cap sections: rows are contiguous
    for r in range(len(rows) - 1):
        ra, rb = rows[r], rows[r + 1]
        for j in range(n_lon):
            a, b = ra[j], ra[(j + 1) % n_lon]
            c, d = rb[(j + 1) % n_lon], rb[j]
            faces.append((a, d, b))
            faces.append((b, d, c))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def _cylinder(radius: float, half_len: float, n_lon: int = 12):
    verts, faces = [], []
    top, bot = [], []
    for j in range(n_lon):
        ph = 2 * math.pi * j / n_lon
        x, y = radius * math.cos(ph), radius * math.sin(ph)
        top.append(len(verts)); verts.append((x, y, half_len))
        bot.append(len(verts)); verts.append((x, y, -half_len))
    ct = len(verts); verts.append((0, 0, half_len))
    cb = len(verts); verts.append((0, 0, -half_len))
    for j in range(n_lon):
        a, b = top[j], top[(j + 1) % n_lon]
        c, d = bot[j], bot[(j + 1) % n_lon]
        faces.append((a, d, b))
        faces.append((b, d, c))
        faces.append((ct, a, b))
        faces.append((cb, d, c))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


_BOX_V = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32
)
_BOX_F = np.array(
    [
        [0, 1, 3], [0, 3, 2],  # -x
        [4, 7, 5], [4, 6, 7],  # +x
        [0, 5, 1], [0, 4, 5],  # -y
        [2, 3, 7], [2, 7, 6],  # +y
        [0, 2, 6], [0, 6, 4],  # -z
        [1, 5, 7], [1, 7, 3],  # +z
    ],
    np.int32,
)


def _plane(half_x: float, half_y: float, n: int = 8):
    """Checkered plane grid; returns verts, faces, and a parity flag/face."""
    xs = np.linspace(-half_x, half_x, n + 1)
    ys = np.linspace(-half_y, half_y, n + 1)
    verts, faces, parity = [], [], []
    for i in range(n):
        for j in range(n):
            base = len(verts)
            verts += [
                (xs[i], ys[j], 0.0), (xs[i + 1], ys[j], 0.0),
                (xs[i + 1], ys[j + 1], 0.0), (xs[i], ys[j + 1], 0.0),
            ]
            faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
            parity += [(i + j) % 2] * 2
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(parity, np.int32),
    )


def tessellate_geom(r, gid: int):
    """Returns (verts (V,3) float32 local frame, faces (F,3) int32,
    face_colors (F,3) float32) for one geom of the render fields ``r``, or
    None to skip: a geom nearly transparent, or a height field (the JAX
    renderer skips them too; the freeze lets no SDF geom through)."""
    gtype = int(r.geom_type[gid])
    size = r.geom_size[gid]
    rgba = np.asarray(r.geom_rgba[gid], np.float32)
    if rgba[3] < 0.1:
        return None
    color = np.asarray(rgba[:3], np.float32)

    if gtype == M.GEOM_PLANE:
        hx = float(size[0]) if size[0] > 0 else 2.0
        hy = float(size[1]) if size[1] > 0 else 2.0
        v, f, parity = _plane(hx, hy)
        c = np.where(
            parity[:, None] == 0, color[None, :] * 0.85, color[None, :] * 1.1
        ).astype(np.float32)
        return v, f, np.clip(c, 0, 1)
    if gtype == M.GEOM_SPHERE:
        v = _SPHERE_V * float(size[0])
        f = _SPHERE_F
    elif gtype == M.GEOM_CAPSULE:
        v, f = _capsule(float(size[0]), float(size[1]))
    elif gtype == M.GEOM_ELLIPSOID:
        v = _SPHERE_V * np.asarray(size[:3], np.float32)
        f = _SPHERE_F
    elif gtype == M.GEOM_CYLINDER:
        v, f = _cylinder(float(size[0]), float(size[1]))
    elif gtype == M.GEOM_BOX:
        v = _BOX_V * np.asarray(size[:3], np.float32)
        f = _BOX_F
    elif gtype == M.GEOM_MESH:
        mid = int(r.geom_dataid[gid])
        va, vn = int(r.mesh_vertadr[mid]), int(r.mesh_vertnum[mid])
        fa, fn = int(r.mesh_faceadr[mid]), int(r.mesh_facenum[mid])
        v = np.asarray(r.mesh_vert[va : va + vn], np.float32)
        f = np.asarray(r.mesh_face[fa : fa + fn], np.int32)
    else:  # a height field
        return None
    c = np.broadcast_to(color, (len(f), 3)).astype(np.float32)
    return v, f, c


# --- camera ----------------------------------------------------------------


def _perspective(fovy_deg: float, aspect: float, near: float, far: float):
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = f / aspect
    P[1, 1] = f
    P[2, 2] = (far + near) / (near - far)
    P[2, 3] = 2 * far * near / (near - far)
    P[3, 2] = -1.0
    return P


def _view(cam_pos: np.ndarray, cam_xmat: np.ndarray):
    R = cam_xmat.reshape(3, 3)  # world <- cam
    V = np.eye(4, dtype=np.float32)
    V[:3, :3] = R.T
    V[:3, 3] = -R.T @ cam_pos
    return V


def _default_camera(r):
    """Free orbit camera from the model statistics (mujoco's default view)."""
    center = np.asarray(r.stat_center, np.float64)
    dist = 1.5 * float(r.stat_extent)
    az, el = math.radians(90.0), math.radians(-20.0)
    fwd = np.array(
        [math.cos(el) * math.cos(az), math.cos(el) * math.sin(az), math.sin(el)]
    )
    pos = center - dist * fwd
    z = -fwd  # camera -Z looks at the scene
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return pos.astype(np.float32), np.stack([x, y, z], axis=1).astype(np.float32).ravel()


# --- renderer --------------------------------------------------------------


class NativeRenderer:
    """``mujoco.Renderer``'s surface over arrays: ``update_scene(geom_xpos,
    geom_xmat, cam_xpos, cam_xmat, camera)`` then ``render()``."""

    def __init__(self, r, height: int = 480, width: int = 640):
        self._r = r
        self._h, self._w = int(height), int(width)
        self._lib = load_library("rasterizer")
        self._lib.btt_raster.restype = None

        tri_geom, tri_local, tri_color = [], [], []
        for gid in range(r.ngeom):
            tess = tessellate_geom(r, gid)
            if tess is None:
                continue
            v, f, c = tess
            tri_local.append(v[f])  # (F,3,3)
            tri_geom.append(np.full(len(f), gid, np.int32))
            tri_color.append(c)
        self._tri_local = np.concatenate(tri_local, axis=0)
        self._tri_geom = np.concatenate(tri_geom, axis=0)
        self._colors = np.ascontiguousarray(np.concatenate(tri_color, axis=0))
        self._ntri = len(self._tri_geom)
        self._world = np.empty((self._ntri, 3, 3), np.float32)
        self._out = np.empty((self._h, self._w, 3), np.uint8)
        self._viewproj = np.eye(4, dtype=np.float32)
        self._light = np.asarray([-0.35, -0.4, 0.85], np.float32)
        self._light /= np.linalg.norm(self._light)
        self._bg = np.asarray([0.9, 0.92, 0.95], np.float32)

    @property
    def viewproj(self) -> np.ndarray:
        """The last scene's view-projection matrix (4, 4)."""
        return self._viewproj

    def update_scene(self, geom_xpos, geom_xmat, cam_xpos=None, cam_xmat=None, camera=-1):
        """One frame's geom positions (ngeom, 3) and rotations (ngeom, 9 or
        3, 3), and the cameras' positions (ncam, 3) and frames (ncam, 9 or
        3, 3); ``camera`` an index or a name, -1 the default orbit."""
        r = self._r
        cam_id = camera if isinstance(camera, int) else -1
        if isinstance(camera, str) and camera in r.names_camera:
            cam_id = r.names_camera.index(camera)
        if 0 <= cam_id < r.ncam:
            pos = np.asarray(cam_xpos[cam_id], np.float32)
            xmat = np.asarray(cam_xmat[cam_id], np.float32).reshape(-1)
            fovy = float(r.cam_fovy[cam_id])
        else:
            pos, xmat = _default_camera(r)
            fovy = 45.0
        extent = max(float(r.stat_extent), 1e-3)
        P = _perspective(fovy, self._w / self._h, 0.01 * extent, 50.0 * extent)
        self._viewproj = np.ascontiguousarray(P @ _view(pos, xmat))

        R = np.asarray(geom_xmat, np.float32).reshape(-1, 3, 3)[self._tri_geom]
        t = np.asarray(geom_xpos, np.float32)[self._tri_geom]
        np.einsum("tij,tvj->tvi", R, self._tri_local, out=self._world)
        self._world += t[:, None, :]

    def render(self) -> np.ndarray:
        c = ctypes.c_void_p
        self._lib.btt_raster(
            c(self._world.ctypes.data),
            c(self._colors.ctypes.data),
            ctypes.c_int(self._ntri),
            c(self._viewproj.ctypes.data),
            c(self._light.ctypes.data),
            ctypes.c_float(0.45),
            ctypes.c_int(self._w),
            ctypes.c_int(self._h),
            c(self._bg.ctypes.data),
            c(self._out.ctypes.data),
        )
        return self._out.copy()

    def close(self):
        pass
