"""3-D Delaunay tetrahedralization (Bowyer–Watson) + Voronoi dual edges.

The capability of the reference's header-only ``DT3D`` (/root/reference/
Inc/DT3D.h:5-316): incremental Bowyer–Watson over tetrahedra with a
super-tetrahedron, circumsphere tests, face-dedup cavity retriangulation, and
a Voronoi dual that connects circumcenters of adjacent tets (DT3D.h:269-315).
(Dead code in the reference's shipping path — voro++ is used instead — but
named by BASELINE.json as a required capability; SURVEY §2.1 C9.)

Design: padded tet table (T_max, 4) + valid mask; one ``fori_loop``
per point insertion; the cavity (tets whose circumsphere contains the point)
is removed and its boundary faces (faces appearing exactly once in the
cavity) are re-joined to the new point — all masked array ops, no recursion.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BIG = 3.4e38


def circumcenter(tets_pts: jax.Array):
    """Circumcenter + squared radius of tetrahedra.

    tets_pts: (..., 4, 3). Solves 2(A - d)ᵀ c = |A|² − |d|² (reference:
    tetrahedron_circumcenter, DT3D.h:10-87, via the same linear system).
    """
    a, b, c, d = (
        tets_pts[..., 0, :], tets_pts[..., 1, :],
        tets_pts[..., 2, :], tets_pts[..., 3, :],
    )
    M = jnp.stack([a - d, b - d, c - d], axis=-2) * 2.0       # (..., 3, 3)
    sq = lambda x: jnp.sum(x * x, axis=-1)
    rhs = jnp.stack([sq(a) - sq(d), sq(b) - sq(d), sq(c) - sq(d)], axis=-1)
    det = jnp.linalg.det(M)
    ok = jnp.abs(det) > 1e-20
    Msafe = jnp.where(ok[..., None, None], M, jnp.eye(3))
    center = jnp.linalg.solve(Msafe, rhs[..., None])[..., 0]
    center = jnp.where(ok[..., None], center, 0.0)
    r2 = sq(center - a)
    r2 = jnp.where(ok, r2, -1.0)  # degenerate tets never capture points
    return center, r2


@functools.partial(jax.jit, static_argnames=("max_tets",))
def delaunay3d(points: jax.Array, mask: jax.Array, max_tets: int | None = None):
    """Incremental Bowyer–Watson. points: (N, 3) padded; mask: (N,).

    Returns dict with tets (T, 4) i32 indices into an extended point array
    (last 4 rows are the super-tet), tet_valid (T,), and the extended points
    (N+4, 3). Tets touching the super-tet are filtered from ``tet_valid``
    but kept in ``tet_valid_all`` for the Voronoi dual.
    """
    N = points.shape[0]
    # Super-tetrahedron enclosing the (masked) cloud (DT3D.h:191-196).
    big = jnp.asarray(BIG, points.dtype)
    m3 = mask[:, None]
    lo = jnp.min(jnp.where(m3, points, big), axis=0)
    hi = jnp.max(jnp.where(m3, points, -big), axis=0)
    center = (lo + hi) / 2
    scale = jnp.max(hi - lo) * 8.0 + 1.0
    sup = center + scale * jnp.asarray(
        [[2.5, -1.0, -1.0], [-2.5, -1.0, -1.0], [0.0, 3.0, -1.0], [0.0, 0.0, 3.5]],
        points.dtype,
    )
    pts = jnp.concatenate([points, sup])                      # (N+4, 3)

    T = max_tets if max_tets is not None else max(8 * N, 64)
    F = 4 * T  # face slots during cavity processing (bounded by tets × 4)

    tets = jnp.zeros((T, 4), jnp.int32).at[0].set(
        jnp.asarray([N, N + 1, N + 2, N + 3], jnp.int32)
    )
    valid = jnp.zeros((T,), bool).at[0].set(True)
    cc, r2 = circumcenter(pts[tets])                          # (T, 3), (T,)

    face_local = jnp.asarray(
        [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], jnp.int32
    )

    def insert(i, carry):
        tets, valid, cc, r2 = carry
        p = pts[i]
        do = mask[i]

        inside = valid & (jnp.sum((cc - p) ** 2, axis=1) <= r2) & do  # cavity
        any_cav = jnp.any(inside)

        # Cavity boundary faces: faces (sorted triples) occurring exactly once
        # among cavity tets (DT3D.h face-dedup insertion, :198-246).
        faces = tets[:, face_local]                            # (T, 4, 3)
        faces = jnp.sort(faces, axis=-1).reshape(T * 4, 3)
        fmask = jnp.repeat(inside, 4)
        same = (
            jnp.all(faces[:, None, :] == faces[None, :, :], axis=-1)
            & fmask[None, :]
        )
        cnt = jnp.sum(same & fmask[:, None], axis=1)
        boundary = fmask & (cnt == 1)

        # New tets: boundary face + p, written into freed/invalid slots.
        new_tet = jnp.concatenate(
            [faces, jnp.full((T * 4, 1), i, jnp.int32)], axis=1
        )
        valid_mid = valid & ~inside
        free_order = jnp.argsort(valid_mid)                   # invalid first
        rank = jnp.cumsum(boundary.astype(jnp.int32)) - boundary.astype(jnp.int32)
        slot = free_order[jnp.minimum(rank, T - 1)]
        wr = boundary & any_cav
        tgt = jnp.where(wr, slot, T)
        tets2 = (
            jnp.zeros((T + 1, 4), jnp.int32)
            .at[:T].set(tets)
            .at[tgt].set(new_tet, mode="drop")[:T]
        )
        valid2 = (
            jnp.zeros((T + 1,), bool)
            .at[:T].set(valid_mid)
            .at[tgt].set(wr, mode="drop")[:T]
        )
        cc2, r22 = circumcenter(pts[tets2])
        changed = valid2 != valid
        keep = lambda new, old: jnp.where(any_cav, new, old)
        return (
            keep(tets2, tets), keep(valid2, valid),
            keep(cc2, cc), keep(r22, r2),
        )

    tets, valid, cc, r2 = jax.lax.fori_loop(
        0, N, insert, (tets, valid, cc, r2)
    )
    touches_super = jnp.any(tets >= N, axis=1)
    return {
        "points": pts,
        "tets": tets,
        "tet_valid": valid & ~touches_super,
        "tet_valid_all": valid,
        "circumcenters": cc,
        "r2": r2,
    }


def voronoi_dual_edges(dt: dict):
    """Voronoi dual: edges between circumcenters of face-adjacent tets
    (reference Voronoi(dt), DT3D.h:269-315).

    Returns (edges (E, 2, 3), edge_mask) with E = 4·T (one slot per tet
    face; each shared face yields one edge, deduped by tet order)."""
    tets = dt["tets"]
    valid = dt["tet_valid"]
    cc = dt["circumcenters"]
    T = tets.shape[0]
    face_local = jnp.asarray(
        [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], jnp.int32
    )
    faces = jnp.sort(tets[:, face_local], axis=-1).reshape(T * 4, 3)
    fmask = jnp.repeat(valid, 4)
    owner = jnp.repeat(jnp.arange(T, dtype=jnp.int32), 4)
    same = (
        jnp.all(faces[:, None, :] == faces[None, :, :], axis=-1)
        & fmask[None, :] & fmask[:, None]
    )
    other = jnp.where(
        same & (owner[None, :] != owner[:, None]), owner[None, :], T
    ).min(axis=1)
    has = (other < T) & fmask & (owner < other)  # dedupe: lower owner emits
    a = cc[owner]
    b = cc[jnp.minimum(other, T - 1)]
    return jnp.stack([a, b], axis=1), has
