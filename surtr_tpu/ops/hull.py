"""Limited incremental convex hull (ICH).

Replacement for ``VMACH::ConvexHull`` (/root/reference/Src/VMACH.cpp:869-1203):
a 3-D incremental hull with *greedy volume-max point insertion* capped at
``limit`` points — the "intermediate convex hull" whose face normals seed the
k-DOP directions (GenerateICHNormal, Surtr.cpp:1961-1982).

Design: faces live in a padded (F, 3) index-triple table with a validity
mask; insertion is a ``fori_loop`` of masked updates (limits are 4-20, so the
serial depth is tiny — SURVEY.md §7 hard-part 6). Horizon detection compares
directed edges of visible faces against reversed edges of hidden faces —
an O(F²) masked comparison instead of the reference's pointer-linked edge map
(Key2Edge string hashing, VMACH.cpp:941-948).

Semantics mirrored:
  * seed tetrahedron from extreme points: max-x, max-distance, max-area,
    max signed volume (BuildFirstHull, VMACH.cpp:1036-1085);
  * per-point priority = Σ_faces max(0, vol(face, p)), updated incrementally
    by removed/added faces (CreateConvexHull, VMACH.cpp:1087-1137);
  * points whose insertion sees no visible face still count as processed
    (AddPointToHull early-out, VMACH.cpp:1008-1013).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -3.4e38


def _vol(tri_pts: jax.Array, p: jax.Array) -> jax.Array:
    """Signed 6×volume of tet (tri, p): det(a-p, b-p, c-p).

    Positive when p is on the inner side of a CCW-outward face — the
    reference's ConvexHull::Volume (VMACH.cpp:924-939).
    """
    a = tri_pts[..., 0, :] - p
    b = tri_pts[..., 1, :] - p
    c = tri_pts[..., 2, :] - p
    return jnp.sum(a * jnp.cross(b, c), axis=-1)


@functools.partial(jax.jit, static_argnames=("limit", "max_faces"))
def ich(
    points: jax.Array,
    mask: jax.Array,
    limit: int,
    max_faces: int | None = None,
):
    """Greedy limited incremental hull.

    Args:
      points: (N, 3) padded point cloud; mask: (N,) validity; limit: max
        number of inserted points (reference ICHIncludePointLimit /
        RefittingPointLimit).

    Returns dict with:
      faces: (F, 3) i32 point indices; face_valid: (F,) bool;
      normals: (F, 3) unit outward normals; inner: (3,) interior point.
    """
    N = points.shape[0]
    F = max_faces if max_faces is not None else 2 * max(limit, 4) + 4
    pts = points
    big_neg = jnp.asarray(NEG, pts.dtype)

    # --- seed tetrahedron (BuildFirstHull semantics) ---
    mx = jnp.where(mask, pts[:, 0], big_neg)
    i1 = jnp.argmax(mx)
    d1 = jnp.where(mask, jnp.sum((pts - pts[i1]) ** 2, -1), big_neg)
    i2 = jnp.argmax(d1)
    e12 = pts[i2] - pts[i1]
    area = jnp.where(
        mask, jnp.sum(jnp.cross(e12, pts - pts[i1]) ** 2, -1), big_neg
    )
    i3 = jnp.argmax(area)
    tri = jnp.stack([pts[i1], pts[i2], pts[i3]])
    v4vol = jnp.where(mask, _vol(tri, pts), big_neg)
    i4 = jnp.argmax(v4vol)

    idx4 = jnp.stack([i1, i2, i3, i4])
    inner = jnp.mean(pts[idx4], axis=0)

    init_faces = jnp.stack(
        [
            jnp.stack([i1, i2, i3]),
            jnp.stack([i1, i2, i4]),
            jnp.stack([i1, i3, i4]),
            jnp.stack([i2, i3, i4]),
        ]
    )

    def orient(f):
        tp = pts[f]
        v = _vol(tp, inner)
        return jnp.where(v < 0, f[jnp.array([0, 2, 1])], f)

    init_faces = jax.vmap(orient)(init_faces)

    faces = jnp.zeros((F, 3), jnp.int32).at[:4].set(init_faces.astype(jnp.int32))
    fvalid = jnp.zeros((F,), bool).at[:4].set(True)

    processed = jnp.zeros((N,), bool).at[idx4].set(True)

    def vols_all(faces, fvalid):
        """(N, F) signed volumes of every (face, point) pair."""
        tp = pts[faces]                                    # (F, 3, 3)
        a = tp[:, 0][None] - pts[:, None]                  # (N, F, 3)
        b = tp[:, 1][None] - pts[:, None]
        c = tp[:, 2][None] - pts[:, None]
        v = jnp.sum(a * jnp.cross(b, c), axis=-1)
        return jnp.where(fvalid[None, :], v, 0.0)

    v0 = vols_all(faces, fvalid)
    priority = jnp.sum(jnp.maximum(v0, 0.0), axis=1)
    priority = jnp.where(mask & ~processed, priority, big_neg)

    # Insertions beyond the point count are no-ops (every point processed →
    # `can` is False); clamping to the static pool size drops them from the
    # compiled loop (the 8-vert cube workload pays 4 iterations, not 16).
    n_insert = max(min(limit, N) - 4, 0)

    def body(_, carry):
        faces, fvalid, processed, priority = carry
        k = jnp.argmax(priority)
        p = pts[k]
        can = priority[k] > big_neg / 2  # any unprocessed point left

        tp = pts[faces]
        volf = jnp.where(fvalid, _vol(tp, p), 0.0)
        visible = fvalid & (volf < 0)
        any_vis = jnp.any(visible) & can

        # Directed edges of every face: (F, 3, 2).
        e0 = faces
        e1 = jnp.roll(faces, -1, axis=1)
        # Horizon: edge of a visible face whose twin (reversed) lives on a
        # hidden valid face.
        # match[f, e, g, h] over flattened edge tables.
        fe0 = e0.reshape(-1)          # (3F,)
        fe1 = e1.reshape(-1)
        owner_vis = jnp.repeat(visible, 3)
        owner_val = jnp.repeat(fvalid, 3)
        twin = (fe0[:, None] == fe1[None, :]) & (fe1[:, None] == fe0[None, :])
        twin = twin & owner_val[None, :]
        twin_hidden = jnp.any(twin & ~owner_vis[None, :], axis=1)
        horizon = owner_vis & owner_val & twin_hidden       # (3F,)

        # New faces (a, b, k) on free slots (invalidate visible first).
        fvalid_mid = fvalid & ~(visible & any_vis)
        free_order = jnp.argsort(fvalid_mid)                # invalid slots first
        rank = jnp.cumsum(horizon.astype(jnp.int32)) - horizon.astype(jnp.int32)
        slot = free_order[jnp.minimum(rank, F - 1)]
        # zeros_like + k (not full_like): composes with shard_map vma typing.
        new_face = jnp.stack(
            [fe0, fe1, jnp.zeros_like(fe0) + k], axis=1
        ).astype(jnp.int32)
        # Orient against the fixed interior point.
        nv = _vol(pts[new_face], inner)
        new_face = jnp.where(
            (nv < 0)[:, None], new_face[:, jnp.array([0, 2, 1])], new_face
        )
        do = horizon & any_vis
        tgt = jnp.where(do, slot, F)
        faces2 = (
            jnp.zeros((F + 1, 3), jnp.int32)
            .at[:F]
            .set(faces)
            .at[tgt]
            .set(new_face, mode="drop")[:F]
        )
        fvalid2 = (
            jnp.zeros((F + 1,), bool)
            .at[:F]
            .set(fvalid_mid)
            .at[tgt]
            .set(do, mode="drop")[:F]
        )

        # Priority update: subtract removed visible, add new faces.
        v_old = vols_all(faces, visible)
        v_new = vols_all(faces2, fvalid2 & ~fvalid_mid)
        dp = jnp.sum(jnp.maximum(v_new, 0.0), 1) - jnp.sum(
            jnp.maximum(v_old, 0.0), 1
        )
        priority2 = jnp.where(mask & ~processed, priority + dp, big_neg)

        processed2 = processed.at[k].set(processed[k] | can)
        priority2 = priority2.at[k].set(big_neg)

        # If nothing visible (or no point), only mark processed.
        faces_out = jnp.where(any_vis, faces2, faces)
        fvalid_out = jnp.where(any_vis, fvalid2, fvalid)
        prio_out = jnp.where(any_vis, priority2, priority.at[k].set(big_neg))
        return faces_out, fvalid_out, processed2, prio_out

    faces, fvalid, processed, priority = jax.lax.fori_loop(
        0, n_insert, body, (faces, fvalid, processed, priority)
    )

    tp = pts[faces]
    nrm = jnp.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0])
    ln = jnp.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / jnp.maximum(ln, 1e-30)
    fvalid = fvalid & (ln[:, 0] > 1e-20)
    return {
        "faces": faces,
        "face_valid": fvalid,
        "normals": jnp.where(fvalid[:, None], nrm, 0.0),
        "inner": inner,
    }


def tetra_hull(points: jax.Array, mask: jax.Array):
    """Seed tetrahedron only (the ``limit <= 4`` ICH): gather-free.

    Exactly BuildFirstHull's extreme-point selection (VMACH.cpp:1036-1085),
    but every "value at argmax" is a one-hot contraction instead of an
    index gather — the refit stage vmaps this over every fracture
    candidate, where each gather would become a batched gather.

    Returns dict with normals (4, 3), face_valid (4,), inner (3,) —
    same convention as ``ich``.
    """
    dtype = points.dtype
    big_neg = jnp.asarray(NEG, dtype)

    def at_max(score):
        """(value-at-argmax) one-hot: first max wins ties."""
        m = score >= jnp.max(score, axis=-1, keepdims=True)
        m = m & (jnp.cumsum(m.astype(jnp.int32), axis=-1) == 1)
        w = m.astype(dtype)
        return jnp.sum(w[..., None] * points, axis=-2)

    s1 = jnp.where(mask, points[..., 0], big_neg)
    p1 = at_max(s1)
    d1 = jnp.where(mask, jnp.sum((points - p1[..., None, :]) ** 2, -1), big_neg)
    p2 = at_max(d1)
    e12 = p2 - p1
    area = jnp.where(
        mask,
        jnp.sum(jnp.cross(e12[..., None, :], points - p1[..., None, :]) ** 2, -1),
        big_neg,
    )
    p3 = at_max(area)
    a = p1[..., None, :] - points
    b = p2[..., None, :] - points
    c = p3[..., None, :] - points
    v4 = jnp.where(mask, jnp.sum(a * jnp.cross(b, c), -1), big_neg)
    p4 = at_max(v4)

    inner = (p1 + p2 + p3 + p4) * 0.25
    tets = [
        (p1, p2, p3),
        (p1, p2, p4),
        (p1, p3, p4),
        (p2, p3, p4),
    ]
    nrms, valids = [], []
    for (fa, fb, fc) in tets:
        n = jnp.cross(fb - fa, fc - fa)
        # Orient outward: flip when the interior point is on the + side.
        s = jnp.sum(n * (inner - fa), axis=-1, keepdims=True)
        n = jnp.where(s > 0, -n, n)
        ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
        nrms.append(n / jnp.maximum(ln, 1e-30))
        valids.append(ln[..., 0] > 1e-20)
    normals = jnp.stack(nrms, axis=-2)                    # (..., 4, 3)
    face_valid = jnp.stack(valids, axis=-1)               # (..., 4)
    normals = jnp.where(face_valid[..., None], normals, 0.0)
    return {"normals": normals, "face_valid": face_valid, "inner": inner}


def ich_contains(hull: dict, points: jax.Array, pts_pool: jax.Array) -> jax.Array:
    """Containment test against an ICH (reference: ConvexHull::Contains,
    VMACH.cpp:885-894): inside iff vol(face, p) > 0 for all faces."""
    tp = pts_pool[hull["faces"]]                             # (F, 3, 3)
    a = tp[:, 0][None] - points[:, None]
    b = tp[:, 1][None] - points[:, None]
    c = tp[:, 2][None] - points[:, None]
    v = jnp.sum(a * jnp.cross(b, c), axis=-1)                # (P, F)
    ok = (v > 0) | ~hull["face_valid"][None, :]
    return jnp.all(ok, axis=1)
