"""Camera / light transforms.

Mirrors the reference's matrix conventions where they matter for parity:
perspective camera (Surtr.cpp:262-283), directional-light ortho frustum fit
to the scene bounds (Surtr.cpp:289-327), NDC depth in [0, 1] (D3D style).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = target - eye
    f = f / jnp.maximum(jnp.linalg.norm(f), 1e-12)
    r = jnp.cross(f, up)
    r = r / jnp.maximum(jnp.linalg.norm(r), 1e-12)
    u = jnp.cross(r, f)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(r).at[1, :3].set(u).at[2, :3].set(-f)
    t = jnp.stack([-jnp.sum(r * eye), -jnp.sum(u * eye), jnp.sum(f * eye)])
    return m.at[:3, 3].set(t)


def perspective(fov_deg, aspect, znear, zfar):
    """Right-handed, depth → [0, 1]."""
    f = 1.0 / jnp.tan(jnp.deg2rad(fov_deg) / 2.0)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(f / aspect)
    m = m.at[1, 1].set(f)
    m = m.at[2, 2].set(zfar / (znear - zfar))
    m = m.at[2, 3].set(znear * zfar / (znear - zfar))
    m = m.at[3, 2].set(-1.0)
    return m


def ortho(l, r, b, t, n, f):
    """Right-handed ortho, depth → [0, 1]."""
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(2.0 / (r - l)).at[0, 3].set(-(r + l) / (r - l))
    m = m.at[1, 1].set(2.0 / (t - b)).at[1, 3].set(-(t + b) / (t - b))
    m = m.at[2, 2].set(1.0 / (n - f)).at[2, 3].set(n / (n - f))
    return m


def light_view_proj(light_dir, center, radius):
    """Directional-light ortho frustum fit to a bounding sphere — the
    reference fits to a radius-100 scene sphere (Surtr.cpp:289-327); we fit
    to the actual scene bounds."""
    d = jnp.asarray(light_dir, jnp.float32)
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
    center = jnp.asarray(center, jnp.float32)
    eye = center - d * (2.0 * radius)
    up = jnp.where(jnp.abs(d[1]) > 0.95, jnp.array([1.0, 0, 0]), jnp.array([0, 1.0, 0]))
    view = look_at(eye, center, up)
    proj = ortho(-radius, radius, -radius, radius, 0.1, 4.0 * radius)
    return jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST)
