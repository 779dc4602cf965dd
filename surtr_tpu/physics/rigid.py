"""Quaternion / rigid-body math utilities (batched, f32).

Conventions: quaternions are (w, x, y, z), unit length; angular velocity is
in world frame; inertia tensors are stored in body frame (diagonalization not
required — full 3×3), world inverse inertia is R I⁻¹ Rᵀ.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_identity(shape=()):
    q = jnp.zeros(shape + (4,))
    return q.at[..., 0].set(1.0)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_normalize(q: jax.Array) -> jax.Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, 1e-12)


def quat_to_mat(q: jax.Array) -> jax.Array:
    """(..., 4) → (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: jax.Array, w: jax.Array, dt) -> jax.Array:
    """q ← normalize(q + dt/2 · (0, ω) ⊗ q)."""
    zero = jnp.zeros_like(w[..., :1])
    wq = jnp.concatenate([zero, w], axis=-1)
    return quat_normalize(q + 0.5 * dt * quat_mul(wq, q))


def rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors by quaternions (broadcasting on leading dims)."""
    R = quat_to_mat(q)
    return jnp.sum(R * v[..., None, :], axis=-1)


def world_inv_inertia(q: jax.Array, inv_I_body: jax.Array) -> jax.Array:
    """R I⁻¹ Rᵀ as broadcast sums (no batched 3×3 matmuls)."""
    R = quat_to_mat(q)
    RI = jnp.sum(R[..., :, :, None] * inv_I_body[..., None, :, :], axis=-2)
    return jnp.sum(RI[..., :, None, :] * R[..., None, :, :], axis=-1)
