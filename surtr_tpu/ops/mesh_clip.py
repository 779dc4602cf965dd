"""Visual-mesh (triangle soup) clipping and solid queries.

The reference clips the visual mesh as an adjacency polyhedron with cap
closure (Poly::ClipPolyhedron on Piece::Mesh, Surtr.cpp:1470-1472). This
design clips the *triangle soup* instead: each triangle × plane-list clip is
an independent masked Sutherland–Hodgman over a small padded polygon, then a
fan re-triangulation — fully parallel over triangles. Cut-surface caps are
taken from the convex proxy's cap faces (DESIGN.md: documented divergence —
convex quantities stay exact, caps can overshoot slightly for non-convex
meshes).

``point_in_mesh`` (ray-parity test) supplies the solid-occupancy query used to
keep interior fracture cells that contain no surface triangles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _clip_polys_plane(
    poly: jax.Array, n_vert: jax.Array, plane: jax.Array, tol,
    any_removed=None,
):
    """SH-clip a batch of small CONVEX polygons by one plane.

    poly: (T, S, 3); n_vert: (T,); plane: (4,) shared, or (T, 4) per-row
    (the pair-pool mesh clip gives every pooled polygon its own cell
    plane). ``any_removed``: the "this plane removes material" context for
    the in-plane-polygon drop rule — None = global any over the batch (the
    per-cell soup semantics); the pair pool passes a per-row per-CELL
    reduction so unrelated cells sharing the pool don't leak into each
    other's rule. Returns same shapes. Keeps n·x + d < 0.

    Cyclic-run emission (same trick as the GPU plane-fold kernel): a plane
    cuts a convex loop in at most two edges, so the kept vertices are one
    contiguous cyclic run and the cut adds exactly [exit, enter] after it.
    Emitting [rotated run, exit, enter] (a rotation of the classic SH
    stream — downstream fan triangulation is rotation-invariant) replaces
    the O(S²) one-hot compaction, which dominated the model-scale mesh
    clip."""
    T, S, _ = poly.shape
    if plane.ndim == 1:
        n, d = plane[:3], plane[3]
    else:
        n, d = plane[:, None, :3], plane[:, None, 3]
    slot = jnp.arange(S, dtype=jnp.int32)
    m = slot[None, :] < n_vert[:, None]
    dist = jnp.sum(poly * n, axis=-1) + d
    rolled = jnp.roll(poly, -1, axis=1)
    is_last = slot[None, :] == n_vert[:, None] - 1
    v_next = jnp.where(is_last[..., None], poly[:, 0:1, :], rolled)
    d_next = jnp.sum(v_next * n, axis=-1) + d
    kept = m & (dist <= tol)
    denom = d_next - dist
    safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
    p_cut = (poly * d_next[..., None] - v_next * dist[..., None]) / safe[..., None]

    cross_exit = m & (dist < -tol) & (d_next > tol)
    cross_enter = m & (dist > tol) & (d_next < -tol)
    f_ex = cross_exit.astype(poly.dtype)[..., None]
    f_en = cross_enter.astype(poly.dtype)[..., None]
    exit_p = jnp.sum(f_ex * p_cut, axis=1)                   # (T, 3)
    enter_p = jnp.sum(f_en * p_cut, axis=1)
    ex_i = jnp.any(cross_exit, axis=1).astype(jnp.int32)    # (T,)
    en_i = jnp.any(cross_enter, axis=1).astype(jnp.int32)

    # Run start a = kept vertex whose cyclic predecessor is removed.
    kept_i = kept.astype(jnp.int32)
    kprev = jnp.concatenate(
        [
            jnp.sum(jnp.where(is_last, kept_i, 0), 1, keepdims=True),
            kept_i[:, :-1],
        ],
        axis=1,
    )
    startm = kept & (kprev == 0)
    nstarts = jnp.sum(startm.astype(jnp.int32), axis=1)      # (T,)
    a = jnp.sum(jnp.where(startm, slot[None], 0), axis=1)    # (T,)
    mcnt = jnp.sum(kept_i, axis=1)

    # rot[j] = poly[(a+j) mod n_vert] via two log-step barrel shifts.
    b_amt = jnp.where(a > 0, n_vert - a, 0)
    xl = xr = poly
    a2 = a[:, None, None]
    b2 = b_amt[:, None, None]
    t = 1
    while t < S:
        bit_l = ((a2 // t) % 2) > 0
        moved_l = jnp.concatenate(
            [xl[:, t:, :], jnp.zeros((T, t, 3), poly.dtype)], axis=1
        )
        xl = jnp.where(bit_l, moved_l, xl)
        bit_r = ((b2 // t) % 2) > 0
        moved_r = jnp.concatenate(
            [jnp.zeros((T, t, 3), poly.dtype), xr[:, : S - t, :]], axis=1
        )
        xr = jnp.where(bit_r, moved_r, xr)
        t *= 2
    rot = jnp.where(slot[None, :, None] < b_amt[:, None, None], xl, xr)

    in_run = slot[None] < mcnt[:, None]
    at_exit = (slot[None] == mcnt[:, None]) & (ex_i[:, None] > 0)
    at_enter = (slot[None] == (mcnt + ex_i)[:, None]) & (en_i[:, None] > 0)
    out = jnp.where(
        in_run[..., None],
        rot,
        jnp.where(
            at_exit[..., None],
            exit_p[:, None, :],
            jnp.where(at_enter[..., None], enter_p[:, None, :], 0.0),
        ),
    )
    n_out = jnp.minimum(mcnt + ex_i + en_i, S)
    # Drop polygons lying wholly IN the cutting plane when the plane actually
    # removes material: they are old cap geometry on this plane, and the new
    # cap face re-covers the full cross-section — keeping both double-layers
    # the surface (breaks ray parity and island labeling).
    inplane = jnp.all((jnp.abs(dist) <= tol) | ~m, axis=1) & (n_vert > 0)
    if any_removed is None:
        any_removed = jnp.any(m & (dist > tol))
    n_out = jnp.where(inplane & any_removed, 0, n_out)
    # Convexity guard: a convex loop has EXACTLY one kept cyclic run. If
    # f32 drift ever produces a kept/removed/kept classification, the run
    # rotation and the single exit/enter sums above would emit garbage —
    # drop the polygon instead (bounded, and counted by the caller like
    # every other capacity loss).
    multirun = nstarts > 1
    n_out = jnp.where(multirun, 0, n_out)
    return out, jnp.where(n_out >= 3, n_out, 0), multirun


@functools.partial(jax.jit, static_argnames=("max_out", "poly_slots", "tol"))
def clip_trisoup(
    corners: jax.Array,
    tri_valid: jax.Array,
    planes: jax.Array,
    plane_mask: jax.Array,
    max_out: int,
    poly_slots: int = 8,
    tol: float = 1e-6,
):
    """Clip a triangle soup by a convex plane list.

    Args:
      corners: (T, 3, 3) triangle corner positions; tri_valid: (T,);
      planes: (K, 4); plane_mask: (K,); max_out: output triangle capacity.

    Returns (out_corners (max_out, 3, 3), out_valid (max_out,), n_dropped).
    """
    T = corners.shape[0]
    S = poly_slots
    poly = jnp.zeros((T, S, 3), corners.dtype).at[:, :3].set(corners)
    n_vert = jnp.where(tri_valid, 3, 0).astype(jnp.int32)

    def body(carry, xs):
        poly, n_vert, mdrop = carry
        plane, ok = xs
        p2, n2, mrun = _clip_polys_plane(poly, n_vert, plane, tol)
        poly = jnp.where(ok, p2, poly)
        n_vert = jnp.where(ok, n2, n_vert)
        mdrop = mdrop + jnp.where(ok, jnp.sum(mrun.astype(jnp.int32)), 0)
        return (poly, n_vert, mdrop), None

    (poly, n_vert, multirun_drops), _ = jax.lax.scan(
        body, (poly, n_vert, jnp.int32(0)), (planes, plane_mask)
    )

    # Fan re-triangulation: polygon with n verts → n-2 triangles, packed
    # front-aligned. Static-size dispatch: the fused one-hot compaction is
    # faster but materializes O(E · max_out); above the threshold (vmapped
    # fracture grids OOM'd at 300 GB) use the searchsorted row packing.
    from surtr_tpu.ops.linalg import compact, pack_rows

    fan = jnp.arange(S, dtype=jnp.int32)  # fan index k → tri (0, k+1, k+2)
    i1 = jnp.minimum(fan + 1, S - 1)
    i2 = jnp.minimum(fan + 2, S - 1)
    tris = jnp.stack(
        [
            jnp.broadcast_to(poly[:, 0:1, :], (T, S, 3)),
            poly[:, i1, :],
            poly[:, i2, :],
        ],
        axis=2,
    )                                                        # (T, S, 3, 3)
    counts = jnp.maximum(n_vert - 2, 0)
    total = jnp.sum(counts)
    if T * S * max_out <= 1 << 17:
        fan_ok = fan[None, :] < counts[:, None]
        out, _ = compact(tris.reshape(T * S, 9), fan_ok.reshape(-1), max_out)
    else:
        out, _ = pack_rows(tris.reshape(T, S, 9), counts, max_out)
    out = out.reshape(max_out, 3, 3)
    out_valid = jnp.arange(max_out) < total
    dropped = jnp.maximum(total - max_out, 0) + multirun_drops
    return out, out_valid, dropped


def clip_polys_by_rows(
    corners: jax.Array,
    valid: jax.Array,
    planes: jax.Array,
    pmask: jax.Array,
    seg_starts: jax.Array | None = None,
    seg_id: jax.Array | None = None,
    poly_slots: int = 8,
    tol: float = 1e-6,
):
    """Clip P independent triangles, each by ITS OWN plane list.

    The pair-pool mesh clip: instead of clipping a per-cell triangle pool
    of uniform capacity (90% padding at model scale — p50 keep is ~54 of a
    512-slot pool), the pipeline compacts the live (cell, triangle) pairs
    into one flat pool and every pooled polygon folds its own cell's
    planes. corners: (P, 3, 3); valid: (P,); planes: (P, K, 4); pmask:
    (P, K). ``seg_starts`` (C+1,) / ``seg_id`` (P,): rows grouped by cell
    in CONTIGUOUS runs — used to evaluate the in-plane-polygon drop rule
    per cell (scatter-free: boundary cumsum differences + one gather).
    Returns (poly (P, S, 3), n_vert (P,), multirun_drops)."""
    P = corners.shape[0]
    S = poly_slots
    poly = jnp.zeros((P, S, 3), corners.dtype).at[:, :3].set(corners)
    n_vert = jnp.where(valid, 3, 0).astype(jnp.int32)
    slot = jnp.arange(S, dtype=jnp.int32)

    def body(carry, xs):
        poly, n_vert, mdrop = carry
        pl, ok = xs                                   # (P, 4), (P,)
        ctx = None
        if seg_starts is not None:
            dist = jnp.sum(poly * pl[:, None, :3], -1) + pl[:, None, 3]
            m = slot[None, :] < n_vert[:, None]
            rm = (jnp.any(m & (dist > tol), axis=1) & ok).astype(jnp.int32)
            cs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(rm)])
            per_seg = cs[seg_starts[1:]] - cs[seg_starts[:-1]]
            ctx = (per_seg > 0)[seg_id]               # (P,) bool
        p2, n2, mrun = _clip_polys_plane(
            poly, n_vert, pl, tol, any_removed=ctx
        )
        poly = jnp.where(ok[:, None, None], p2, poly)
        n_vert = jnp.where(ok, n2, n_vert)
        mdrop = mdrop + jnp.sum((mrun & ok).astype(jnp.int32))
        return (poly, n_vert, mdrop), None

    (poly, n_vert, drops), _ = jax.lax.scan(
        body,
        (poly, n_vert, jnp.int32(0)),
        (jnp.swapaxes(planes, 0, 1), jnp.swapaxes(pmask, 0, 1)),
    )
    return poly, n_vert, drops


def fan_triangles(poly: jax.Array, n_vert: jax.Array):
    """Fan re-triangulation of padded polygons: (P, S, 3) + counts →
    ((P, S, 3, 3) fan triangles, (P,) triangle counts = max(n−2, 0))."""
    P, S, _ = poly.shape
    fan = jnp.arange(S, dtype=jnp.int32)
    i1 = jnp.minimum(fan + 1, S - 1)
    i2 = jnp.minimum(fan + 2, S - 1)
    tris = jnp.stack(
        [
            jnp.broadcast_to(poly[:, 0:1, :], (P, S, 3)),
            poly[:, i1, :],
            poly[:, i2, :],
        ],
        axis=2,
    )
    return tris, jnp.maximum(n_vert - 2, 0)


def point_in_mesh(points: jax.Array, corners: jax.Array, tri_valid: jax.Array):
    """Ray-parity solid test: odd ray crossings ⇒ inside.

    points: (P, 3); corners: (T, 3, 3). Returns (P,) bool. Watertight input
    assumed (all reference models are closed — SURVEY §1 L2). The ray uses a
    fixed *generic* direction so axis-aligned edges/diagonals (ubiquitous in
    boxy models) are not hit exactly — an exact-edge hit double-counts and
    flips the parity.
    """
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    # Möller–Trumbore along a generic fixed direction, batched (P, T).
    d = jnp.array([0.8138294, 0.40996888, 0.41189286], corners.dtype)
    e1 = b - a
    e2 = c - a
    pvec = jnp.cross(d, e2)                                  # (T, 3)
    det = jnp.sum(e1 * pvec, axis=-1)                        # (T,)
    ok = jnp.abs(det) > 1e-12
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = points[:, None, :] - a[None]                      # (P, T, 3)
    u = jnp.sum(tvec * pvec[None], -1) * inv[None]
    qvec = jnp.cross(tvec, e1[None])                         # (P, T, 3)
    v = jnp.sum(qvec * d, -1) * inv[None]
    t = jnp.sum(qvec * e2[None], -1) * inv[None]
    hit = (
        ok[None]
        & tri_valid[None]
        & (u >= 0)
        & (v >= 0)
        & (u + v <= 1)
        & (t > 1e-9)
    )
    return (jnp.sum(hit, axis=1) % 2) == 1


def winding_inside(
    points: jax.Array, corners: jax.Array, tri_valid: jax.Array,
    threshold: float = 0.5,
):
    """Generalized winding-number solid test (Van Oosterom–Strackee).

    points: (P, 3); corners: (T, 3, 3). Returns (P,) bool. Robust where ray
    parity is not: the fracture pipeline's capped piece meshes are only
    approximately watertight (cap overshoot, T-junctions), which flips ray
    parity; the winding number degrades gracefully (≈1 inside, ≈0 outside,
    ≈0.5 on the wall) so a 0.5 threshold stays reliable.
    """
    a = corners[None, :, 0] - points[:, None]                # (P, T, 3)
    b = corners[None, :, 1] - points[:, None]
    c = corners[None, :, 2] - points[:, None]
    la = jnp.linalg.norm(a, axis=-1)
    lb = jnp.linalg.norm(b, axis=-1)
    lc = jnp.linalg.norm(c, axis=-1)
    det = jnp.sum(a * jnp.cross(b, c), axis=-1)
    den = (
        la * lb * lc
        + jnp.sum(a * b, -1) * lc
        + jnp.sum(b * c, -1) * la
        + jnp.sum(c * a, -1) * lb
    )
    omega = 2.0 * jnp.arctan2(det, den)                      # (P, T)
    total = jnp.sum(jnp.where(tri_valid[None], omega, 0.0), axis=-1)
    # Winding sign depends on triangle orientation; the pipeline's meshes are
    # outward-CCW but clipped caps may flip — compare |w| against threshold.
    return jnp.abs(total) > threshold * 4.0 * jnp.pi


def unique_corner_verts(corners: jax.Array, tri_valid: jax.Array):
    """Flattened (possibly duplicated) corner pool: ((3T, 3), (3T,) mask).
    Duplicates are harmless for supports / hull seeding."""
    T = corners.shape[0]
    return corners.reshape(3 * T, 3), jnp.repeat(tri_valid, 3)


def build_parity_grid(corners: jax.Array, tri_valid: jax.Array, res: int = 64):
    """Global inside-solid parity grid for ONE closed triangle soup.

    Precomputes inside/outside at the centers of a res³ grid over the soup's
    bounding box via vertical-ray crossing parity (one (res², T) ray sweep +
    one fused (res², T, res) count — shared by every later query). The
    fracture pipeline's island-connectivity sweep asks ~10⁶ inside-solid
    queries per event against the SAME source solid; per-query winding
    numbers (winding_inside) cost P·T·atan2, while sampling this grid is
    one gather.

    Column x/y coordinates sit at irrational fractions of a cell so rays
    never hit the axis-aligned vertices/edges of boxy models exactly (an
    exact edge hit double-counts and flips parity — same trick as
    point_in_mesh's generic ray direction).

    Returns a dict {lo (3,), ext (3,), res, inside (res³,) bool}; query with
    ``parity_grid_inside``. Accuracy: queries snap to cell centers (≤ half a
    cell, bbox/res ≈ 1.6% of the model at the default 64) — the consumers'
    own voxel resolution is coarser.
    """
    R = int(res)
    c2 = corners.reshape(-1, 3)
    m2 = jnp.repeat(tri_valid, 3)
    big = jnp.asarray(3.4e38, corners.dtype)
    lo = jnp.min(jnp.where(m2[:, None], c2, big), axis=0)
    hi = jnp.max(jnp.where(m2[:, None], c2, -big), axis=0)
    ext = jnp.maximum(hi - lo, 1e-6)
    lo = lo - 0.005 * ext
    ext = ext * 1.01

    fx, fy = 0.381966, 0.618034  # golden-ratio cell offsets
    ar = jnp.arange(R, dtype=corners.dtype)
    xs = lo[0] + (ar + fx) / R * ext[0]
    ys = lo[1] + (ar + fy) / R * ext[1]
    zc = lo[2] + (ar + 0.5) / R * ext[2]

    A, B, Cc = corners[:, 0], corners[:, 1], corners[:, 2]
    px = jnp.repeat(xs, R)                                   # (R², ) x-major
    py = jnp.tile(ys, R)

    # 2-D edge functions of each triangle's xy projection vs every column.
    def edge(p0, p1):
        return (
            (p1[None, :, 0] - p0[None, :, 0]) * (py[:, None] - p0[None, :, 1])
            - (p1[None, :, 1] - p0[None, :, 1]) * (px[:, None] - p0[None, :, 0])
        )                                                    # (R², T)

    e0 = edge(A, B)
    e1 = edge(B, Cc)
    e2 = edge(Cc, A)
    area = (
        (B[:, 0] - A[:, 0]) * (Cc[:, 1] - A[:, 1])
        - (B[:, 1] - A[:, 1]) * (Cc[:, 0] - A[:, 0])
    )                                                        # (T,)
    ok = (jnp.abs(area) > 1e-14) & tri_valid
    s = jnp.sign(area)[None]
    hit = (
        ok[None]
        & (e0 * s >= 0)
        & (e1 * s >= 0)
        & (e2 * s >= 0)
    )                                                        # (R², T)
    inv_a = 1.0 / jnp.where(jnp.abs(area) > 1e-14, area, 1.0)
    sia = s * jnp.abs(inv_a)[None]                           # (1, T) = 1/area
    w0 = e1 * sia                                            # bary at (px,py)
    w1 = e2 * sia
    w2 = 1.0 - w0 - w1
    zhit = w0 * A[None, :, 2] + w1 * B[None, :, 2] + w2 * Cc[None, :, 2]
    zhit = jnp.where(hit, zhit, big)

    # Crossings below each z-bin center → parity. The (R², T, R) compare
    # fuses into the axis-1 reduce (never materialized).
    cnt = jnp.sum(
        (zhit[:, :, None] < zc[None, None, :]) & hit[:, :, None],
        axis=1,
        dtype=jnp.int32,
    )                                                        # (R², R)
    inside = (cnt % 2) == 1
    return {
        "lo": lo,
        "ext": ext,
        "res": jnp.int32(R),
        "inside": inside.reshape(R * R * R),
        "_static_res": R,
    }


def parity_grid_inside(grid: dict, points: jax.Array) -> jax.Array:
    """Sample a ``build_parity_grid`` result at (P, 3) points → (P,) bool.
    Points outside the grid's bounding box are outside the solid."""
    R = grid["_static_res"]
    lo, ext = grid["lo"], grid["ext"]
    rel = (points - lo[None]) / ext[None] * R
    fx, fy = 0.381966, 0.618034
    ix = jnp.round(rel[:, 0] - fx).astype(jnp.int32)
    iy = jnp.round(rel[:, 1] - fy).astype(jnp.int32)
    iz = jnp.round(rel[:, 2] - 0.5).astype(jnp.int32)
    inb = (
        (ix >= 0) & (ix < R) & (iy >= 0) & (iy < R) & (iz >= 0) & (iz < R)
    )
    flat = (
        jnp.clip(ix, 0, R - 1) * (R * R)
        + jnp.clip(iy, 0, R - 1) * R
        + jnp.clip(iz, 0, R - 1)
    )
    return grid["inside"][flat] & inb
