"""Convex polytope clipping against half-spaces.

The replacement for the reference's clipping workhorses:
  * ``Poly::ClipPolyhedron`` (/root/reference/Src/Poly.cpp:265-554) — in-place
    vertex-adjacency surgery over a plane list, and
  * ``VMACH::Polygon3D::ClipWithPlane`` (/root/reference/Src/VMACH.cpp:550-851)
    — face clipping with sequential cut-edge chaining for the cap face.

Design (DESIGN.md): faces are clipped *independently* by a masked,
vectorized Sutherland–Hodgman pass (no cross-face dependency), and the cap face
is reconstructed by *angular sorting* of the cut points — valid because every
polytope on this path is convex. A multi-plane clip is a ``lax.scan`` fold; a
batch of polytopes is a ``vmap``.

The fold is written scatter/gather-free, so that under vmap it stays fused
broadcast-multiply+reduce work: ring neighbors via roll+fix, stream
compaction via cumsum + one-hot contraction, cap-slot insertion via masked
select.

Sign convention: plane (n, d), signed distance s(x) = n·x + d, the KEPT side is
s(x) < 0 (reference: ComparePlanePoint, Poly.cpp:716-723). Points with
|s| <= tol count as kept/in-plane (reference comp == 0).

Determinism note: the edge/plane intersection formula
``(a·s_b − b·s_a)/(s_b − s_a)`` (reference: PlaneLineIntersection,
Poly.cpp:746-751) is sign-symmetric — swapping (a, b) negates both numerator
and denominator — so the two faces sharing an edge produce bitwise-identical
cut points, which the cap deduplication relies on. This replaces the
reference's string-hash endpoint ordering (VMACH.cpp:63-76).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surtr_tpu.types import ConvexPoly

DEFAULT_TOL = 1e-6
CAPS = 3  # cap-point slots per face (a convex face cuts in ≤2; 3 for safety)


from surtr_tpu.ops.linalg import compact as _compact


def _loop_next(fv: jax.Array, nv: jax.Array):
    """Next vertex around each padded loop, gather-free (roll + first-fix)."""
    S = fv.shape[-2]
    slot = jnp.arange(S, dtype=jnp.int32)
    rolled = jnp.roll(fv, -1, axis=-2)
    is_last = (slot[None, :] == nv[..., None] - 1)
    return jnp.where(is_last[..., None], fv[..., 0:1, :], rolled)


def plane_basis(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Deterministic orthonormal basis (u, v) with u × v = n (n unit).

    One-hot compare, NOT ``zeros().at[axis].set(1)``: under a vmap the
    scatter form lowers to a batched scatter (the exact-caps path calls this
    per candidate × cut face)."""
    a = jnp.abs(n)
    axis = jnp.argmin(a)
    e = (jnp.arange(3) == axis).astype(n.dtype)
    u = jnp.cross(e, n)
    u = u / jnp.maximum(jnp.linalg.norm(u), 1e-30)
    v = jnp.cross(n, u)
    return u, v


def clip_poly_plane(
    poly: ConvexPoly, plane: jax.Array, tol: float = DEFAULT_TOL
) -> ConvexPoly:
    """Clip one convex polytope by one plane, keeping the n·x + d < 0 side.

    Static shapes (F, S) in and out; the cap face (cut closure, reference
    VMACH.cpp:699-813) goes into the first free face slot.
    """
    F, S = poly.F, poly.S
    fv = poly.face_verts          # (F, S, 3)
    nv = poly.n_verts             # (F,)
    n = plane[:3]
    d = plane[3]

    slot = jnp.arange(S, dtype=jnp.int32)
    m = slot[None, :] < nv[:, None]
    dist = jnp.sum(fv * n, axis=-1) + d                  # (F, S)
    v_next = _loop_next(fv, nv)
    d_next = jnp.sum(v_next * n, axis=-1) + d

    kept = m & (dist <= tol)
    cross = m & (
        ((dist < -tol) & (d_next > tol)) | ((dist > tol) & (d_next < -tol))
    )
    denom = d_next - dist
    safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
    p_cut = (fv * d_next[:, :, None] - v_next * dist[:, :, None]) / safe[:, :, None]

    # --- Sutherland–Hodgman emission: per slot emit [v if kept][p if cross].
    flags = jnp.stack([kept, cross], axis=-1).reshape(F, 2 * S)
    vals = jnp.stack([fv, p_cut], axis=-2).reshape(F, 2 * S, 3)
    out_fv, n_out = _compact(vals, flags, S)
    new_nv = jnp.where(n_out >= 3, n_out, 0)

    # --- Cap face: points ON the plane (crossings + in-plane vertices of
    # faces that lost a vertex; reference comp == 0 handling,
    # Poly.cpp:369-427), compacted to CAPS slots per face, then angularly
    # sorted around the centroid.
    removed = m & (dist > tol)
    face_touched = jnp.any(removed, axis=1)
    inplane = m & (jnp.abs(dist) <= tol) & face_touched[:, None]
    any_removed = jnp.any(removed)
    cand = (cross | inplane) & any_removed
    cand_pts = jnp.where(cross[..., None], p_cut, fv)
    pool, pool_n = _compact(cand_pts, cand, CAPS)        # (F, CAPS, 3)
    pool_mask = (
        jnp.arange(CAPS, dtype=jnp.int32)[None, :] < pool_n[:, None]
    ).reshape(F * CAPS)
    cap_pts = pool.reshape(F * CAPS, 3)

    cnt = jnp.sum(pool_mask)
    wsum = jnp.sum(jnp.where(pool_mask[:, None], cap_pts, 0.0), axis=0)
    centroid = wsum / jnp.maximum(cnt, 1)
    u, v = plane_basis(n / jnp.maximum(jnp.linalg.norm(n), 1e-30))
    rel = cap_pts - centroid
    ang = jnp.arctan2(jnp.sum(rel * v, -1), jnp.sum(rel * u, -1))
    key = jnp.where(pool_mask, ang, jnp.inf)
    order = jnp.argsort(key)
    # Gather-free permutation: one-hot contraction over F*CAPS entries.
    P = F * CAPS
    onehot = (order[:, None] == jnp.arange(P, dtype=jnp.int32)[None, :])
    sorted_pts = jnp.sum(
        onehot[..., None].astype(fv.dtype) * cap_pts[None, :, :], axis=1
    )
    # Invalid keys are +inf, so valid entries sort to the front.
    sorted_mask = jnp.arange(P, dtype=jnp.int32) < cnt
    # Duplicates (bitwise-identical across the two faces sharing an edge /
    # exact vertex copies) sort adjacently — keep the first of each run.
    prev = jnp.roll(sorted_pts, 1, axis=0).at[0].set(jnp.inf)
    dup = jnp.all(sorted_pts == prev, axis=-1)
    keep = sorted_mask & ~dup
    cap_fv, n_cap = _compact(sorted_pts, keep, S)
    has_cap = n_cap >= 3

    # Write cap into the first free slot (masked select, no scatter).
    free = new_nv == 0
    cap_slot = jnp.argmax(free)
    can_place = has_cap & jnp.any(free)
    at_slot = jnp.arange(F, dtype=jnp.int32) == cap_slot
    put = (at_slot & can_place)
    new_fv = jnp.where(put[:, None, None], cap_fv[None], out_fv)
    new_nv = jnp.where(put, n_cap, new_nv)
    new_planes = jnp.where(put[:, None], plane[None], poly.planes)

    # Degenerate polytope (fewer than 4 faces) is cleared — the analogue of
    # the reference's `polyhedron.size() < 4` wipe (Poly.cpp:506-507).
    alive = jnp.sum((new_nv >= 3).astype(jnp.int32)) >= 4
    new_nv = jnp.where(alive, new_nv, 0)

    return ConvexPoly(new_fv, new_nv, new_planes)


def clip_poly_planes(
    poly: ConvexPoly,
    planes: jax.Array,
    plane_mask: jax.Array | None = None,
    tol: float = DEFAULT_TOL,
) -> ConvexPoly:
    """Fold ``clip_poly_plane`` over a (K, 4) plane list with a validity mask.

    The analogue of the reference's plane loop in Poly::ClipPolyhedron
    (Poly.cpp:291-300) — but as a ``lax.scan`` so it stays inside one jit.
    """
    K = planes.shape[0]
    if plane_mask is None:
        plane_mask = jnp.ones((K,), bool)

    def body(p, xs):
        plane, ok = xs
        q = clip_poly_plane(p, plane, tol)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(ok, (1,) * a.ndim), b, a), p, q
        )
        return out, None

    out, _ = jax.lax.scan(body, poly, (planes, plane_mask))
    return out


def clip_poly_poly(
    poly: ConvexPoly, clipper: ConvexPoly, tol: float = DEFAULT_TOL
) -> ConvexPoly:
    """Clip ``poly`` by every face plane of ``clipper``.

    The analogue of ``Poly::ClipPolyhedron(polyhedron, Polygon3D)``
    (Poly.cpp:548-560) used for per-Voronoi-cell fracture clipping.
    Intersecting with an *empty* clipper yields the empty polytope.
    """
    out = clip_poly_planes(poly, clipper.planes, clipper.face_mask(), tol)
    nv = jnp.where(clipper.is_empty(), 0, out.n_verts)
    return ConvexPoly(out.face_verts, nv, out.planes)


@functools.partial(jax.jit, static_argnames=("tol",))
def clip_batch_by_cells(
    pieces: ConvexPoly, cells: ConvexPoly, tol: float = DEFAULT_TOL
) -> ConvexPoly:
    """(P pieces) × (C cells) grid clip — the fracture fan-out.

    Replaces the 16-thread per-cell task fan-out (m_fractureTask,
    /root/reference/Src/Surtr.cpp:1457-1504, 2129-2146) with a 2-D vmap.
    Returns a ConvexPoly with batch shape (P, C).
    """
    one = lambda piece, cell: clip_poly_poly(piece, cell, tol)
    over_cells = jax.vmap(one, in_axes=(None, 0))
    return jax.vmap(over_cells, in_axes=(0, None))(pieces, cells)


def contains_point(
    poly: ConvexPoly, x: jax.Array, tol: float = DEFAULT_TOL
) -> jax.Array:
    """Point-in-polytope via face planes (reference: VMACH.cpp:480-489)."""
    s = jnp.sum(poly.planes[..., :3] * x, axis=-1) + poly.planes[..., 3]
    ok = (s <= tol) | ~poly.face_mask()
    return jnp.all(ok, axis=-1) & ~poly.is_empty()
