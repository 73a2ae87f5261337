"""4x4 transforms (reference util/transform.{h,cpp}).

A Transform is a pair (m, m_inv) of 4x4 matrices. Host-side construction uses
numpy float64 for precision; device application is float32 jnp. Functions work
on packed (..., 3) point/vector/normal arrays.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from . import struct


@struct.dataclass
class Transform:
    m: jnp.ndarray       # (4, 4)
    m_inv: jnp.ndarray   # (4, 4)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(m=self.m @ other.m, m_inv=other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(m=self.m_inv, m_inv=self.m)

    def _host(self, p):
        """True when both the matrix and the operand are host arrays —
        the scene parser applies thousands of tiny per-shape transforms,
        and routing those through jnp costs a device dispatch per op
        (measured 257s of a 530s 8.5k-shape parse)."""
        import numpy as _np
        return isinstance(self.m, _np.ndarray) and \
            isinstance(p, (_np.ndarray, list, tuple, float, int))

    def apply_point(self, p):
        if self._host(p):
            import numpy as _np
            m = _np.asarray(self.m, _np.float32)
            p = _np.asarray(p, _np.float32)
            x = p @ m[:3, :3].T + m[:3, 3]
            w = p @ m[3, :3] + m[3, 3]
            return x / _np.where(w[..., None] == 0, 1.0, w[..., None])
        m = jnp.asarray(self.m, jnp.float32)
        x = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return x / jnp.where(w[..., None] == 0, 1.0, w[..., None])

    def apply_vector(self, v):
        if self._host(v):
            import numpy as _np
            return _np.asarray(v, _np.float32) @ \
                _np.asarray(self.m, _np.float32)[:3, :3].T
        m = jnp.asarray(self.m, jnp.float32)
        return v @ m[:3, :3].T

    def apply_normal(self, n):
        """Normals transform by the inverse transpose (reference transform.h)."""
        if self._host(n):
            import numpy as _np
            return _np.asarray(n, _np.float32) @ \
                _np.asarray(self.m_inv, _np.float32)[:3, :3]
        mi = jnp.asarray(self.m_inv, jnp.float32)
        return n @ mi[:3, :3]

    def swaps_handedness(self) -> bool:
        return bool(np.linalg.det(np.asarray(self.m)[:3, :3]) < 0)

    def is_identity(self) -> bool:
        return bool(np.allclose(np.asarray(self.m), np.eye(4)))


def identity() -> Transform:
    return Transform(m=np.eye(4, dtype=np.float32), m_inv=np.eye(4, dtype=np.float32))


def from_matrix(m) -> Transform:
    m = np.asarray(m, np.float64).reshape(4, 4)
    return Transform(m=m.astype(np.float32),
                     m_inv=np.linalg.inv(m).astype(np.float32))


def translate(delta) -> Transform:
    d = np.asarray(delta, np.float64)
    m = np.eye(4)
    m[:3, 3] = d
    mi = np.eye(4)
    mi[:3, 3] = -d
    return Transform(m=m.astype(np.float32), m_inv=mi.astype(np.float32))


def scale(sx, sy=None, sz=None) -> Transform:
    if sy is None:
        sy = sz = sx
    m = np.diag([sx, sy, sz, 1.0])
    mi = np.diag([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0])
    return Transform(m=m.astype(np.float32), m_inv=mi.astype(np.float32))


def rotate_x(deg) -> Transform:
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)
    return Transform(m=m.astype(np.float32), m_inv=m.T.astype(np.float32))


def rotate_y(deg) -> Transform:
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64)
    return Transform(m=m.astype(np.float32), m_inv=m.T.astype(np.float32))


def rotate_z(deg) -> Transform:
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    m = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    return Transform(m=m.astype(np.float32), m_inv=m.T.astype(np.float32))


def rotate(deg, axis) -> Transform:
    """Rotation about arbitrary axis (reference transform.cpp Rotate)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return Transform(m=m.astype(np.float32), m_inv=m.T.astype(np.float32))


def look_at(eye, look, up) -> Transform:
    """Camera-to-world transform (reference transform.cpp LookAt)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    dir_ = look - eye
    dir_ = dir_ / np.linalg.norm(dir_)
    right = np.cross(up / np.linalg.norm(up), dir_)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right /= nr
    new_up = np.cross(dir_, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = dir_
    c2w[:3, 3] = eye
    return Transform(m=c2w.astype(np.float32),
                     m_inv=np.linalg.inv(c2w).astype(np.float32))


def perspective(fov_deg, n, f) -> Transform:
    """Perspective projection (reference transform.cpp Perspective)."""
    persp = np.array([[1, 0, 0, 0],
                      [0, 1, 0, 0],
                      [0, 0, f / (f - n), -f * n / (f - n)],
                      [0, 0, 1, 0]], np.float64)
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return from_matrix(np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp)


def orthographic(znear, zfar) -> Transform:
    return from_matrix(np.diag([1.0, 1.0, 1.0 / (zfar - znear), 1.0]) @
                       np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                                 [0, 0, 1, -znear], [0, 0, 0, 1]], np.float64))
