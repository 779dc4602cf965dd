"""Exact cut-surface caps for clipped visual meshes.

The reference clips the visual mesh as a CLOSED polyhedron and reconstructs
exact cap cross-sections by chaining cut edges into loops
(Poly::ClipPolyhedron, /root/reference/Src/Poly.cpp:265-554; cap chaining
/root/reference/Src/VMACH.cpp:699-813). Rounds 1-3 approximated the caps with
the refit convex's cut faces — exact on convex models, but on concave models
the convex cut face crosses OUTSIDE the true surface (bunny: convex volume
totalled 1.705x the mesh volume, capped-mesh signed volume 0.70x —
PARITY.md divergence 1).

This module computes the caps EXACTLY, post-hoc, from quantities the pipeline
already has — no change to the hot clip folds:

    cap_t  =  face_t(candidate convex)  ∩  (solid cross-section at plane t)

with the standard boundary decomposition of an intersection of regions,
emitted as a SIGNED fan triangulation (exact for moments/winding/refit even
when fan triangles of opposite orientation overlap):

  * dA — the part of the cap boundary ON the solid surface: exactly the
    edges of the final clipped surface triangles whose endpoints both lie on
    plane t. They are already clipped by every other plane and already
    restricted to the candidate's island, and closed-mesh orientation says
    the cap traverses each such edge OPPOSITE to the surface triangle.
  * dB — the part of the cap boundary on OTHER cut planes (where two cut
    planes meet inside the material): the portions of the convex face t's
    edge loop that lie inside the solid. Each loop edge is split at its 2-D
    crossings with the dA segments and each sub-interval is kept iff its
    midpoint (nudged toward the face interior) is inside the solid.

Every emitted cap vertex except the fan origin lies ON the true piece
boundary, so feeding them (and not the origin) to the refit pool makes the
refit convex tight around the true solid — the other half of the concave
parity fix. The fan origin is the mean of the boundary points, hence inside
their convex hull and inside the refit convex.

Degenerate fan pairs (interior diagonals of the clipped polygons lying on the
plane) cancel in all signed quantities; they only cost triangle slots.

Performance shape (round 4): candidate edge RECORDS [p, q, face, kind] are
front-compacted into a flat per-candidate pool of ``cfg.cap_edge_pool`` slots
BEFORE any inside-solid probing — the padded (CF, NA) + (CF, S, X+1) record
grid holds ~4.4k slots of which ~100 are real at model scale, and the probe
query (two points per record) would be 9.5M parity-grid gathers per model-
scale event if issued at padded width. Probe geometry (midpoint + inward
nudge ± off-plane excursion) is derivable from [p, q, face plane] alone, so
it is computed only at the compacted slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = 3.4e38


def match_cut_faces(poly, cut_planes, cut_mask, scale, tol=1e-4):
    """(..., F) bool — faces of ``poly`` whose plane equals one of the cut
    planes (cap faces carry the cut plane bitwise, so a loose tolerance
    suffices)."""
    from surtr_tpu.ops.linalg import supports

    n = poly.planes[..., :3]
    d = poly.planes[..., 3]
    ndot = supports(
        n, jnp.broadcast_to(cut_planes[..., :3], n.shape[:-2] + cut_planes.shape[-2:-1] + (3,))
    )
    dm = jnp.abs(d[..., None] - cut_planes[..., None, :, 3])
    hit = (jnp.abs(ndot - 1.0) < tol) & (dm < tol * scale) & cut_mask[..., None, :]
    return jnp.any(hit, axis=-1) & poly.face_mask()


def _cap_candidates_one(
    conv, mtris, mmask, cut_planes, cut_mask, mas, cfg, profile_stage=99
):
    """Phase 1 (single candidate): candidate cap-boundary edge records.

    Returns a dict:
      rec    (RT, 8)  [p(3), q(3), face_id, kind] — kind 0 = dA (surface
                      cross-section edge), 1 = dB (loop-edge sub-interval);
                      RT = CF·NA + CF·S·(X+1)
      flag   (RT,)    record is a live candidate (pre-probe filters only:
                      capacity, degeneracy, dA-coverage)
      pls    (CF, 4)  cut-face planes (probe geometry + fan origins)
      cf_ok  (CF,)
      n_over ()       capacity losses so far (cut faces + dA edges)
    """
    from surtr_tpu.ops.clip import plane_basis

    F, S = conv.F, conv.S
    CF = cfg.cap_faces
    NA = cfg.cap_edges
    X = cfg.cap_crossings
    Tp = mtris.shape[0]
    tol_on = 1e-5 * jnp.maximum(mas, 1.0)
    eps2 = (1e-6 * jnp.maximum(mas, 1.0)) ** 2

    # Front-compact the cut faces and gather their data with ONE one-hot
    # contraction — vmapped top_k lowers to batched variadic sorts and
    # vmapped row gathers to batched gathers.
    cut_sel = match_cut_faces(conv, cut_planes, cut_mask, mas)   # (F,)
    pos = jnp.cumsum(cut_sel.astype(jnp.int32)) - cut_sel.astype(jnp.int32)
    oh = (
        cut_sel[None, :] & (pos[None, :] == jnp.arange(CF)[:, None])
    ).astype(conv.face_verts.dtype)                              # (CF, F)
    n_cf = jnp.sum(cut_sel)
    cf_ok = jnp.arange(CF) < n_cf
    n_cf_over = jnp.maximum(n_cf - CF, 0)

    # Broadcast-multiply-sum, not einsum: (CF, F) x (F, ...) is a tiny
    # batched matmul (ops/linalg.py), and this keeps full f32.
    loops = jnp.sum(
        oh[:, :, None, None] * conv.face_verts[None], axis=1
    )                                                            # (CF, S, 3)
    nv = jnp.sum(oh * conv.n_verts[None].astype(oh.dtype), axis=1).astype(
        jnp.int32
    )
    pls = jnp.sum(oh[:, :, None] * conv.planes[None], axis=1)    # (CF, 4)

    # --- dA: on-plane edges of the final clipped surface soup -------------
    # Vertex distances to every cut face's plane: (CF, Tp, 3) — broadcast
    # multiply-add, not einsum (a batched tiny matmul, see ops/linalg.py).
    dv = (
        pls[:, None, None, 0] * mtris[None, :, :, 0]
        + pls[:, None, None, 1] * mtris[None, :, :, 1]
        + pls[:, None, None, 2] * mtris[None, :, :, 2]
        + pls[:, 3, None, None]
    )
    on = jnp.abs(dv) < tol_on                                    # (CF, Tp, 3)
    all_on = jnp.all(on, axis=-1)
    nxt = jnp.array([1, 2, 0])
    e_on = on & on[..., nxt] & mmask[None, :, None] & ~all_on[..., None]
    ea = jnp.broadcast_to(mtris[None], (CF, Tp, 3, 3)).reshape(CF, 3 * Tp, 3)
    eb = jnp.broadcast_to(mtris[:, nxt][None], (CF, Tp, 3, 3)).reshape(
        CF, 3 * Tp, 3
    )
    e_ok = e_on.reshape(CF, 3 * Tp)
    # dA overflow is counted like every other capacity loss — a lost
    # boundary edge silently breaks cap closure, so it must be observable.
    n_a_over = jnp.sum(
        jnp.maximum(jnp.sum(e_ok, axis=1) - NA, 0) * cf_ok
    )
    # Front-compaction by one-hot contraction (see linalg.compact; the
    # top_k form is a batched variadic sort). Cap edge p->q = (b -> a):
    # the cap traverses the shared edge OPPOSITE to the surface triangle
    # (closed-mesh orientation).
    from surtr_tpu.ops.linalg import compact

    if profile_stage <= 1:   # face selection + on-plane edge masks
        return {"_p": jnp.sum(e_ok) + jnp.sum(loops) + jnp.sum(dv)}
    packed, n_a = compact(
        jnp.concatenate([eb, ea], axis=-1), e_ok, NA
    )                                                            # (CF, NA, 6)
    a_p = packed[..., 0:3]
    a_q = packed[..., 3:6]
    a_ok = (jnp.arange(NA)[None, :] < n_a[:, None]) & cf_ok[:, None]
    a_ok &= jnp.sum((a_p - a_q) ** 2, -1) > eps2
    if profile_stage <= 2:   # + dA compaction
        return {"_p": jnp.sum(packed) + jnp.sum(n_a)}

    # --- dB: loop-edge sub-intervals --------------------------------------
    def per_face(loop, nvf, pl, ap, aq, aok, ok_f):
        n = pl[:3]
        u, v = plane_basis(n)
        cen = jnp.sum(
            jnp.where((jnp.arange(S) < nvf)[:, None], loop, 0.0), axis=0
        ) / jnp.maximum(nvf, 1)
        p2 = lambda x: jnp.stack(
            [jnp.sum((x - cen) * u, -1), jnp.sum((x - cen) * v, -1)], axis=-1
        )
        w2 = p2(loop)                                            # (S, 2)
        slot = jnp.arange(S, dtype=jnp.int32)
        is_last = slot == nvf - 1
        w_next = jnp.where(
            is_last[:, None], loop[0:1], jnp.roll(loop, -1, axis=0)
        )
        w2n = jnp.where(is_last[:, None], w2[0:1], jnp.roll(w2, -1, axis=0))
        edge_ok = (slot < nvf) & ok_f

        q0 = p2(ap)                                              # (NA, 2)
        q1 = p2(aq)
        r = w2n - w2                                             # (S, 2)
        s = q1 - q0                                              # (NA, 2)
        cross2 = lambda a, b: a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
        den = cross2(r[:, None, :], s[None, :, :])               # (S, NA)
        dq = q0[None] - w2[:, None]                              # (S, NA, 2)
        tnum = cross2(dq, s[None])
        unum = cross2(dq, r[:, None])
        safe = jnp.where(jnp.abs(den) > 1e-12, den, 1.0)
        tt = tnum / safe
        uu = unum / safe
        # Generous slack on the dA param: a crossing at a dA endpoint is a
        # junction of the cap boundary — extra splits are harmless (both
        # sub-intervals get probed), missed junctions misclassify a whole
        # interval.
        xv = (
            (jnp.abs(den) > 1e-12)
            & aok[None]
            & (tt > 1e-6) & (tt < 1.0 - 1e-6)
            & (uu > -0.05) & (uu < 1.05)
        )
        # X-pass min extraction, ascending (a vmapped jnp.sort over the NA
        # axis is a batched sort launch). Masking ALL ties per pass merges
        # duplicate crossing params — duplicates only produce zero-length
        # intervals anyway.
        tt_m = jnp.where(xv, tt, 1.0)
        ts_cols = []
        for _ in range(X):
            m = jnp.min(tt_m, axis=1, keepdims=True)             # (S, 1)
            ts_cols.append(m)
            tt_m = jnp.where(tt_m <= m, 1.0, tt_m)
        ts = jnp.concatenate(ts_cols, axis=1)                    # (S, X)
        if profile_stage <= 3:  # + crossings + param extraction
            return {"_p": jnp.sum(ts)}
        bounds = jnp.concatenate(
            [jnp.zeros((S, 1)), ts, jnp.ones((S, 1))], axis=1
        )                                                        # (S, X+2)
        e3 = w_next - loop                                       # (S, 3)
        pts = loop[:, None, :] + bounds[..., None] * e3[:, None, :]
        # dA-coverage: where the solid's surface meets plane t ON this loop
        # edge, the dA segments already supply that boundary piece (with
        # closed-mesh orientation) — a dB interval whose midpoint lies on a
        # dA segment must yield or the boundary doubles. 2-D point-segment
        # distance of each interval midpoint against every dA segment.
        midb = 0.5 * (bounds[:, :-1] + bounds[:, 1:])            # (S, X+1)
        m2 = w2[:, None, :] + midb[..., None] * r[:, None, :]    # (S,X+1,2)
        dq0 = m2[:, :, None, :] - q0[None, None]                 # (S,X+1,NA,2)
        ss = jnp.sum(s * s, -1)                                  # (NA,)
        tproj = jnp.clip(
            jnp.sum(dq0 * s[None, None], -1)
            / jnp.where(ss > 1e-30, ss, 1.0)[None, None],
            0.0, 1.0,
        )
        d2 = jnp.sum(
            (dq0 - tproj[..., None] * s[None, None]) ** 2, -1
        )                                                        # (S,X+1,NA)
        eps_cov = 3e-4 * mas
        covered = jnp.any(
            (d2 < eps_cov * eps_cov) & aok[None, None], axis=-1
        )                                                        # (S, X+1)
        if profile_stage <= 4:  # + dA coverage
            return {"_p": jnp.sum(covered) + jnp.sum(pts)}
        seg2 = (bounds[:, 1:] - bounds[:, :-1]) ** 2 * jnp.sum(e3 * e3, -1)[
            :, None
        ]
        return pts, seg2, edge_ok, covered

    if profile_stage <= 4:
        out = jax.vmap(per_face)(loops, nv, pls, a_p, a_q, a_ok, cf_ok)
        return {"_p": out["_p"]}
    b_pts, b_elen2, b_edge_ok, b_covered = jax.vmap(per_face)(
        loops, nv, pls, a_p, a_q, a_ok, cf_ok
    )

    # --- flat records ------------------------------------------------------
    # [p(3), q(3), face_id, kind]; probe geometry is recomputed from (p, q,
    # face plane) AFTER the batch-level compaction, so padded slots never
    # reach the inside-solid query.
    fidx = jnp.arange(CF, dtype=loops.dtype)
    a_rec = jnp.concatenate(
        [
            a_p, a_q,
            jnp.broadcast_to(fidx[:, None, None], (CF, NA, 1)),
            jnp.zeros((CF, NA, 1), loops.dtype),
        ],
        axis=-1,
    ).reshape(CF * NA, 8)
    e0 = b_pts[:, :, :-1]                                        # (CF,S,X+1,3)
    e1 = b_pts[:, :, 1:]
    b_rec = jnp.concatenate(
        [
            e0, e1,
            jnp.broadcast_to(fidx[:, None, None, None], (CF, S, X + 1, 1)),
            jnp.ones((CF, S, X + 1, 1), loops.dtype),
        ],
        axis=-1,
    ).reshape(CF * S * (X + 1), 8)
    keep_b = (
        ~b_covered
        & b_edge_ok[..., None]
        & (b_elen2 > eps2)
    ).reshape(CF * S * (X + 1))

    return {
        "rec": jnp.concatenate([a_rec, b_rec]),
        "flag": jnp.concatenate([a_ok.reshape(CF * NA), keep_b]),
        "pls": pls,
        "cf_ok": cf_ok,
        "n_over": n_cf_over + n_a_over,
    }


def cap_fans_batch(
    conv, mtris, mmask, cut_planes, cut_mask, solid_t, solid_m, mas, cfg,
    solid_grid=None,
):
    """Exact caps for a candidate batch (leading axis N).

    Args mirror ``_finish_pieces``: conv is the PRE-refit candidate convex
    (its faces on the cut planes bound the true cap exactly — the convex is
    a superset of the piece), mtris/mmask the final clipped (island-masked)
    surface soup, cut_planes/cut_mask the half-spaces applied THIS round
    (pre-existing faces keep their old caps in the soup; the in-plane-polygon
    drop rule in the mesh clip removes old caps on re-cut planes),
    solid_t/solid_m the per-candidate source solids. ``solid_grid`` (from
    ``build_parity_grid`` over ONE shared source solid) replaces per-probe
    winding when available (prepare); do_fracture probes per-candidate
    ray parity against the parent's capped mesh.

    Returns (cap_rows (N, CT, 3, 3), cap_ok (N, CT), pool_v (N, CP, 3),
    pool_m (N, CP), dropped ()).
    """
    from surtr_tpu.ops.linalg import compact
    from surtr_tpu.ops.mesh_clip import parity_grid_inside, point_in_mesh

    CF = cfg.cap_faces
    CT = cfg.cap_tris
    CP = cfg.cap_pool
    # The pre-probe record pool can never usefully be smaller than the
    # requested final cap count — workload-fit configs that raise cap_tris
    # (big-piece decompositions) get the record pool raised with it.
    E = max(cfg.cap_edge_pool, cfg.cap_tris)

    cc = jax.vmap(
        lambda cv, mt, mm, cp, cm: _cap_candidates_one(
            cv, mt, mm, cp, cm, mas, cfg
        )
    )(conv, mtris, mmask, cut_planes, cut_mask)

    rec, flag, pls = cc["rec"], cc["flag"], cc["pls"]
    N, RT, _ = rec.shape

    # Compact candidate record INDICES (i32 one-hot, cheap), then fetch the
    # selected records with ONE flat row gather — the only gather here, at
    # N·E rows instead of per-element.
    idx, n_e = compact(
        jnp.broadcast_to(jnp.arange(RT, dtype=jnp.int32)[None], (N, RT))[
            ..., None
        ],
        flag,
        E,
    )
    idx = idx[..., 0]                                            # (N, E)
    slot_ok = jnp.arange(E)[None, :] < n_e[:, None]
    flat = jnp.arange(N, dtype=jnp.int32)[:, None] * RT + idx
    rec_e = rec.reshape(N * RT, 8)[flat]                         # (N, E, 8)
    pack_over = jnp.sum(flag, axis=1) - n_e                      # (N,)

    p = rec_e[..., 0:3]
    q = rec_e[..., 3:6]
    fid = rec_e[..., 6].astype(jnp.int32)                        # (N, E)
    is_b = rec_e[..., 7] > 0.5

    # Face plane per record (one-hot contraction over CF — tiny).
    ohf = (fid[..., None] == jnp.arange(CF)[None, None]).astype(p.dtype)
    nrm = jnp.sum(ohf[..., None] * pls[:, None, :, 0:3], axis=2)  # (N, E, 3)

    # Two-sided probe pair: in-plane inward nudge (n x edge for a CCW loop /
    # the cap's p->q orientation) PLUS an off-plane excursion along ±n. A
    # true cap-boundary edge has material on BOTH sides of the cut plane
    # next to it; a tangent plane (cut plane grazing the solid's surface —
    # e.g. the Voronoi domain walls at the model's bounding box) has
    # material on at most one side, and a single on-surface probe is an
    # inside-test coin flip. Off-plane excursion δ/4 < the in-plane nudge:
    # when the cut plane is PERPENDICULAR to the surface face holding the
    # edge, the left and ±n components cancel along the face normal
    # (|left·n_S| = sinθ vs |n_t·n_S| = cosθ) and an equal-δ probe lands
    # exactly ON the surface — an inside-test coin flip. δ/4 keeps both
    # probes strictly inside for cut angles θ > ~14°, while the tangent
    # case (θ = 0, left inside the surface) still straddles and rejects.
    e = q - p
    left = jnp.cross(nrm, e)
    ln = jnp.linalg.norm(left, axis=-1, keepdims=True)
    left = left / jnp.where(ln > 1e-30, ln, 1.0)
    d_ = cfg.cap_probe_nudge * mas
    base = 0.5 * (p + q) + left * d_
    probes = jnp.stack(
        [base + nrm * (0.25 * d_), base - nrm * (0.25 * d_)], axis=2
    )                                                            # (N, E, 2, 3)

    if solid_grid is not None:
        inside = parity_grid_inside(
            solid_grid, probes.reshape(-1, 3)
        ).reshape(N, E, 2)
    else:
        # Ray parity, not winding numbers: exact-caps solids are exactly
        # closed (that is the point of this module), parity is robust to
        # the signed canceling fan pairs (two crossings), and the winding
        # form's per-(probe, tri) atan2 was the caps path's largest real
        # cost.
        inside = jax.vmap(point_in_mesh)(
            probes.reshape(N, 2 * E, 3), solid_t, solid_m
        ).reshape(N, E, 2)
    # A boundary edge is real only if BOTH off-plane probes are in material.
    keep = slot_ok & inside[..., 0] & inside[..., 1]             # (N, E)

    # Fan origin per face: mean of the cap's own boundary points (inside
    # their convex hull, hence inside the refit convex).
    ohk = ohf * keep[..., None].astype(p.dtype)                  # (N, E, CF)
    s_f = jnp.sum(ohk[..., None] * (p + q)[:, :, None, :], axis=1)
    cnt = 2.0 * jnp.sum(ohk, axis=1)                             # (N, CF)
    origin = s_f / jnp.maximum(cnt, 1.0)[..., None]              # (N, CF, 3)
    orig_e = jnp.sum(ohf[..., None] * origin[:, None], axis=2)   # (N, E, 3)

    tris = jnp.stack([orig_e, p, q], axis=-2)                    # (N, E, 3, 3)
    cap_rows, n_cap = compact(tris.reshape(N, E, 9), keep, CT)
    cap_rows = cap_rows.reshape(N, CT, 3, 3)
    cap_ok = jnp.arange(CT)[None, :] < n_cap[:, None]
    ct_over = jnp.sum(keep, axis=1) - n_cap

    # Refit-pool vertices: dB interval endpoints (dA endpoints are surface
    # vertices already in the pool; fan origins are NOT boundary points).
    pv = jnp.concatenate([p, q], axis=1)                         # (N, 2E, 3)
    pm = jnp.concatenate([keep & is_b, keep & is_b], axis=1)
    pool_v, n_pool = compact(pv, pm, CP)
    pool_m = jnp.arange(CP)[None, :] < n_pool[:, None]
    # Pool overflow means some cap vertices are NOT fed to the refit — the
    # refit slabs may then cut the cap (mesh poking out of its convex).
    pool_over = jnp.sum(pm, axis=1) - n_pool

    dropped = (
        jnp.sum(cc["n_over"])
        + jnp.sum(pack_over)
        + jnp.sum(ct_over)
        + jnp.sum(pool_over)
    )
    return cap_rows, cap_ok, pool_v, pool_m, dropped
