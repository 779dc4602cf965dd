"""Core pytree types.

``ConvexPoly`` is the central geometric object of the framework — the padded,
fixed-topology replacement for both of the reference's polytope representations
(``VMACH::Polygon3D``, /root/reference/Inc/VMACH.h:11-86, and
``Poly::Polyhedron``, /root/reference/Inc/Poly.h:15-41). See DESIGN.md for the
representation rationale.

Conventions (matching the reference, Poly.cpp:716-751):
  * plane = (nx, ny, nz, d) with signed distance  s(x) = n·x + d
  * INSIDE / kept side of a plane is  s(x) < 0  (normals point outward)
  * face loops wind CCW viewed from outside (right-hand normal = outward)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ConvexPoly:
    """Padded convex polytope as a face soup.

    Attributes:
      face_verts: (..., F, S, 3) f32 — vertex loop per face (positions are
        duplicated across faces; there is no shared vertex pool).
      n_verts:    (..., F) i32 — valid vertex count per face; 0 == invalid face.
      planes:     (..., F, 4) f32 — outward plane (n, d) per face.

    A polytope with all ``n_verts == 0`` is the empty polytope (the analogue of
    the reference's cleared ``polyhedron``, Poly.cpp:321-327).
    """

    face_verts: jax.Array
    n_verts: jax.Array
    planes: jax.Array

    # -- shape helpers (static) --
    @property
    def F(self) -> int:
        return self.face_verts.shape[-3]

    @property
    def S(self) -> int:
        return self.face_verts.shape[-2]

    @property
    def batch_shape(self):
        return self.face_verts.shape[:-3]

    def face_mask(self) -> jax.Array:
        """(..., F) bool — faces with >= 3 vertices."""
        return self.n_verts >= 3

    def slot_mask(self) -> jax.Array:
        """(..., F, S) bool — valid vertex slots."""
        slots = jnp.arange(self.S, dtype=jnp.int32)
        return slots < self.n_verts[..., None]

    def is_empty(self) -> jax.Array:
        """(...,) bool — no valid face."""
        return ~jnp.any(self.face_mask(), axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TriSoup:
    """Padded indexed triangle mesh (visual geometry).

    verts: (..., V, 3) f32; tris: (..., T, 3) i32; tri_valid: (..., T) bool.
    Vertices are welded (shared indices) so connected-component labeling over
    shared vertices reproduces the reference's mesh-island semantics
    (Surtr.cpp:2157-2201).
    """

    verts: jax.Array
    tris: jax.Array
    tri_valid: jax.Array

    @property
    def V(self) -> int:
        return self.verts.shape[-2]

    @property
    def T(self) -> int:
        return self.tris.shape[-2]

    def corners(self) -> jax.Array:
        """(..., T, 3, 3) gathered triangle corner positions."""
        return jnp.take_along_axis(
            self.verts[..., None, :, :],
            self.tris[..., :, :, None].clip(0),
            axis=-2,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RigidState:
    """Batched rigid-body state (the replacement for PhysX actors, SURVEY §2.2 T2).

    x: (..., N, 3) position; q: (..., N, 4) unit quaternion (w, x, y, z);
    v: (..., N, 3) linear velocity; w: (..., N, 3) angular velocity (world);
    inv_mass: (..., N); inv_inertia_body: (..., N, 3, 3) (body frame);
    active: (..., N) bool.
    """

    x: jax.Array
    q: jax.Array
    v: jax.Array
    w: jax.Array
    inv_mass: jax.Array
    inv_inertia_body: jax.Array
    active: jax.Array

    @property
    def N(self) -> int:
        return self.x.shape[-2]


def empty_poly(F: int, S: int, batch_shape=(), dtype=jnp.float32) -> ConvexPoly:
    return ConvexPoly(
        face_verts=jnp.zeros(batch_shape + (F, S, 3), dtype),
        n_verts=jnp.zeros(batch_shape + (F,), jnp.int32),
        planes=jnp.zeros(batch_shape + (F, 4), dtype),
    )


def unit_cube(F: int = 32, S: int = 16, dtype=jnp.float32) -> ConvexPoly:
    """Axis-aligned unit cube centered at the origin ([-0.5, 0.5]^3).

    The reference's ``Poly::GetBB`` starting polytope (Poly.cpp:587-617) and the
    voro++ container domain (Surtr.cpp:2007-2011).
    """
    h = 0.5
    # Faces: +x, -x, +y, -y, +z, -z; loops CCW viewed from outside.
    quads = np.array(
        [
            [[h, -h, -h], [h, h, -h], [h, h, h], [h, -h, h]],      # +x
            [[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]],  # -x
            [[-h, h, -h], [-h, h, h], [h, h, h], [h, h, -h]],      # +y
            [[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]],  # -y
            [[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],      # +z
            [[-h, -h, -h], [-h, h, -h], [h, h, -h], [h, -h, -h]],  # -z
        ],
        dtype=np.float64,
    )
    normals = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=np.float64,
    )
    fv = np.zeros((F, S, 3))
    pl = np.zeros((F, 4))
    nv = np.zeros((F,), np.int32)
    fv[:6, :4] = quads
    pl[:6, :3] = normals
    pl[:6, 3] = -h  # n·x + d = 0 on the face; inside is negative
    nv[:6] = 4
    return ConvexPoly(
        face_verts=jnp.asarray(fv, dtype),
        n_verts=jnp.asarray(nv),
        planes=jnp.asarray(pl, dtype),
    )


def scale_poly(p: ConvexPoly, s) -> ConvexPoly:
    """Anisotropic scale about the origin (reference: Poly::Scale)."""
    s = jnp.broadcast_to(jnp.asarray(s, p.face_verts.dtype), (3,))
    fv = p.face_verts * s
    n = p.planes[..., :3] / s
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    safe = jnp.where(norm > 0, norm, 1.0)
    d = p.planes[..., 3:4] / safe
    n = n / safe
    return ConvexPoly(fv, p.n_verts, jnp.concatenate([n, d], axis=-1))


def translate_poly(p: ConvexPoly, t) -> ConvexPoly:
    """Translate (reference: Poly::Translate)."""
    t = jnp.asarray(t, p.face_verts.dtype)
    fv = p.face_verts + t
    n = p.planes[..., :3]
    d = p.planes[..., 3:4] - jnp.sum(n * t, axis=-1, keepdims=True)
    return ConvexPoly(fv, p.n_verts, jnp.concatenate([n, d], axis=-1))


def transform_poly(p: ConvexPoly, R: jax.Array, t) -> ConvexPoly:
    """Rigid transform x -> R x + t (reference: Poly::Transform)."""
    t = jnp.asarray(t, p.face_verts.dtype)
    hi = jax.lax.Precision.HIGHEST
    fv = jnp.einsum("ij,...j->...i", R, p.face_verts, precision=hi) + t
    n = jnp.einsum("ij,...j->...i", R, p.planes[..., :3], precision=hi)
    d = p.planes[..., 3:4] - jnp.sum(n * t, axis=-1, keepdims=True)
    return ConvexPoly(fv, p.n_verts, jnp.concatenate([n, d], axis=-1))
