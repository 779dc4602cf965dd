"""The VMACH fracture pipeline, jitted end-to-end.

Reference call stacks mirrored (SURVEY §3):
  * ``prepare_fracture``  — PrepareFracture (/root/reference/Src/Surtr.cpp:1747-1827):
    ICH → k-DOP → ACH, initial 64-cell Voronoi decomposition, pattern caching.
  * ``do_fracture``       — DoFracture/ApplyFracture/MergeOutOfImpact/
    HandleConvexIsland/Refitting (Surtr.cpp:1885-1958, 2098-2458).

Design decisions (DESIGN.md):
  * the per-cell thread-pool fan-out (m_fractureTask, Surtr.cpp:1457-1504)
    becomes an (active-pieces × cells) 2-D vmap of the clip kernel;
  * piece bookkeeping is flat & padded (PieceSet) with masked compaction
    (top-volume keep on overflow — the analogue of the reference's silent
    capacity caps, Surtr.h:267-268);
  * HandleConvexIsland's O(F²) coplanar face-pair scan + recursive flood fill
    (Surtr.cpp:2203-2366) becomes a batched coplanar-opposite-face test with
    bounding-sphere overlap + iterative label propagation;
  * visual-mesh caps come from the refit convex's cut faces (documented
    divergence: exact for convex models, slight overshoot on concavities).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surtr_tpu.config import FractureConfig
from surtr_tpu.fracture.pattern import pattern_cells, radial_seeds, uniform_seeds
from surtr_tpu.fracture.types import FractureContext, PieceSet
from surtr_tpu.ops.clip import clip_poly_planes, clip_poly_poly
from surtr_tpu.ops.clip_pallas import clip_planes_batch
from surtr_tpu.ops.hull import ich
from surtr_tpu.ops.kdop import kdop_planes
from surtr_tpu.ops.labels import adjacency_components
from surtr_tpu.ops.mesh_clip import (
    build_parity_grid,
    clip_trisoup,
    parity_grid_inside,
    point_in_mesh,
    winding_inside,
)
from surtr_tpu.ops.moments import moments
from surtr_tpu.types import ConvexPoly, scale_poly, translate_poly, unit_cube

BIG = 3.4e38


# ----------------------------------------------------------------------------
# small helpers
# ----------------------------------------------------------------------------


def convex_out_of_sphere(
    poly: ConvexPoly, cloud: jax.Array, center: jax.Array, radius
) -> jax.Array:
    """ConvexOutOfSphere (Surtr.cpp:2415-2458): a piece is outside the impact
    sphere iff (a) none of its vertices lies within ``radius`` of the center
    AND (b) none of the sphere-cloud points lies inside the convex."""
    fv = poly.face_verts
    sm = poly.slot_mask()
    d2 = jnp.sum((fv - center) ** 2, axis=-1)
    vert_inside = jnp.any(sm & (d2 < radius * radius), axis=(-1, -2))
    # cloud-in-convex: n·p + d <= 0 for all valid faces
    s = (
        jnp.einsum(
            "...fk,pk->...fp",
            poly.planes[..., :3],
            cloud,
            precision=jax.lax.Precision.HIGHEST,
        )
        + poly.planes[..., 3:]
    )
    ok = (s <= 0) | ~poly.face_mask()[..., None]
    cloud_inside = jnp.any(jnp.all(ok, axis=-2), axis=-1) & ~poly.is_empty()
    return ~vert_inside & ~cloud_inside & ~poly.is_empty()


# Cut-face matching shared with the exact-caps module.
from surtr_tpu.ops.caps import match_cut_faces as _match_cut_faces  # noqa: E402


def cut_face_tris(poly: ConvexPoly, face_sel):
    """Fan-triangulate selected faces, row-structured.

    Returns ((F, S-2, 3, 3) fan triangles, (F,) per-face counts) — cap
    geometry for the visual mesh (the closure the reference gets from
    polyhedron clipping, VMACH.cpp:699-813)."""
    F, S = poly.F, poly.S
    fv = poly.face_verts
    fan = jnp.arange(S - 2, dtype=jnp.int32)
    i1 = fan + 1
    i2 = fan + 2
    tris = jnp.stack(
        [
            jnp.broadcast_to(fv[..., 0:1, :], fv[..., : S - 2, :].shape),
            fv[..., i1, :],
            fv[..., i2, :],
        ],
        axis=-2,
    )  # (..., F, S-2, 3, 3)
    counts = jnp.where(face_sel, jnp.maximum(poly.n_verts - 2, 0), 0)
    return tris, counts


def _append_tris(base, base_mask, extra_rows, extra_counts):
    """Place row-structured extra triangles into the FREE slots of a masked
    triangle array (single-piece layout; callers vmap). The base mask need
    not be front-aligned — island splitting leaves candidates with scattered
    masks. Static-size dispatch like clip_trisoup: fused one-hot when small,
    searchsorted row packing when the one-hot would materialize at OOM scale
    under the candidate vmap."""
    from surtr_tpu.ops.linalg import compact, pack_rows

    T = base.shape[-3]
    F, Sf = extra_rows.shape[0], extra_rows.shape[1]
    if F * Sf * T <= 1 << 17:
        fan_ok = (
            jnp.arange(Sf, dtype=jnp.int32)[None, :] < extra_counts[:, None]
        )
        packed, _ = compact(
            extra_rows.reshape(F * Sf, 9), fan_ok.reshape(-1), T
        )
    else:
        packed, _ = pack_rows(extra_rows.reshape(F, Sf, 9), extra_counts, T)
    packed = packed.reshape(T, 3, 3)
    n_extra = jnp.sum(extra_counts)
    # k-th free slot receives the k-th packed cap triangle. One-hot
    # contraction, not packed[rank]: under the candidate vmap the row
    # gather becomes a batched gather, while the (T, T) select fuses.
    free = ~base_mask
    rank = jnp.cumsum(free.astype(jnp.int32)) - free.astype(jnp.int32)
    take = free & (rank < n_extra)
    slot_i = jnp.arange(T, dtype=jnp.int32)
    sel = (rank[:, None] == slot_i[None, :]).astype(base.dtype)  # (T, T)
    shifted = jnp.einsum(
        "ts,sd->td", sel, packed.reshape(T, 9),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(T, 3, 3)
    out = jnp.where(take[:, None, None], shifted, base)
    out = jnp.where(base_mask[:, None, None], base, out)
    out_mask = base_mask | take
    n_free = jnp.sum(free)
    dropped = jnp.maximum(n_extra - n_free, 0)
    return out, out_mask, dropped


def refit_planes(verts: jax.Array, vmask: jax.Array, limit: int):
    """Refitting slab planes (Surtr.cpp:2405-2413): ICH(limit) of the piece's
    vertex pool → k-DOP along its face normals (no outward gap — the
    Polyhedron Calc overload, Kdop.cpp:95-115). Returns ((2K, 4), (2K,))."""
    # limit <= 4 builds exactly the seed tetrahedron: 4 faces, so the padded
    # hull table (and the slab-plane fold) can be 3× tighter — and the
    # gather-free tetra path avoids ~6 batched index gathers per candidate
    # (see ops/hull.py tetra_hull).
    if limit <= 4:
        from surtr_tpu.ops.hull import tetra_hull

        h = tetra_hull(verts, vmask)
    else:
        h = ich(verts, vmask, limit=limit)
    planes, pm = kdop_planes(verts, vmask, h["normals"], h["face_valid"], gap=0.0)
    enough = jnp.sum(vmask) >= 4
    return planes, pm & enough


def refit_convex(
    convex: ConvexPoly,
    verts: jax.Array,
    vmask: jax.Array,
    limit: int,
) -> ConvexPoly:
    """Single-piece refit: slab planes → clip (Kdop::ClipWithPolyhedron)."""
    planes, pm = refit_planes(verts, vmask, limit)
    return clip_poly_planes(convex, planes, pm)


def _cell_plane_sets(seeds: jax.Array, k: int, extent, center):
    """Per-seed half-space sets in world space: the 6 domain faces + the
    k-nearest bisectors, all computed in unit space (voro++ container parity)
    and transformed by the reference's anisotropic scale + translate
    (Surtr.cpp:1798-1803). Returns ((C, k+6, 4), (C, k+6) mask)."""
    from surtr_tpu.ops.voronoi import bisector_planes

    C = seeds.shape[0]
    d2 = jnp.sum((seeds[:, None] - seeds[None]) ** 2, axis=-1)
    big = jnp.asarray(BIG, seeds.dtype)
    d2 = jnp.fill_diagonal(d2, big, inplace=False)
    _, idx = jax.lax.top_k(-d2, k)                          # nearest first

    def one(seed, nbr):
        bp, bm = bisector_planes(seed, seeds[nbr], jnp.ones((k,), bool))
        axes = jnp.concatenate([jnp.eye(3), -jnp.eye(3)]).astype(seeds.dtype)
        dom = jnp.concatenate([axes, jnp.full((6, 1), -0.5, seeds.dtype)], 1)
        return (
            jnp.concatenate([dom, bp]),
            jnp.concatenate([jnp.ones((6,), bool), bm]),
        )

    planes_u, pmask = jax.vmap(one)(seeds, idx)          # (C, k+6, 4)
    # Anisotropic scale about the origin, then translate (scale_poly math).
    n = planes_u[..., :3] / extent
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    safe = jnp.where(ln > 0, ln, 1.0)
    n = n / safe
    d = planes_u[..., 3:4] / safe
    d = d - jnp.sum(n * center, axis=-1, keepdims=True)
    return jnp.concatenate([n, d], axis=-1), pmask


def _two_pass_cell_clip(poly_b, cell_planes, cell_pmask, seeds_w, prefix):
    """Voronoi cell fold in two passes. Plane lists are ordered
    [domain walls, bisectors nearest-first] (_cell_plane_sets), and far
    bisectors rarely cut. Pass 1 folds
    the walls + ``prefix`` nearest bisectors; the remaining planes can cut
    cell i only if n·s_i + d + R_i > tol, where R_i is the pass-1 cell's
    vertex radius about its seed (for every cell vertex v:
    n·v + d ≤ n·s + d + |v − s| ≤ n·s + d + R). Pass 2 folds the tail
    with that mask — provably exact, and almost all tail steps become
    masked distance tests. ``prefix`` ≤ 0 or a short plane list falls
    back to the single-pass fold."""
    Kt = cell_planes.shape[1]
    K1 = 6 + prefix
    if prefix <= 0 or K1 >= Kt:
        return clip_planes_batch(poly_b, cell_planes, cell_pmask)
    conv = clip_planes_batch(
        poly_b, cell_planes[:, :K1], cell_pmask[:, :K1]
    )
    # Exact tail filter: plane can affect the final cell only if it cuts
    # the (larger) pass-1 cell, i.e. its support over the pass-1 vertices
    # is positive. Computed as broadcast multiply-adds (no reduced-precision
    # matmul). Margin 0 vs the fold's cut tolerance keeps the filter
    # conservative: a kept no-op plane costs one masked kernel step.
    fv = conv.face_verts
    tn = cell_planes[:, K1:, :3]                           # (C, K2, 3)
    td = cell_planes[:, K1:, 3]
    d = (
        tn[:, :, None, None, 0] * fv[:, None, :, :, 0]
        + tn[:, :, None, None, 1] * fv[:, None, :, :, 1]
        + tn[:, :, None, None, 2] * fv[:, None, :, :, 2]
        + td[:, :, None, None]
    )                                                      # (C, K2, F, S)
    smax = jnp.max(
        jnp.where(conv.slot_mask()[:, None], d, -BIG), axis=(2, 3)
    )
    need = cell_pmask[:, K1:] & (smax > 0.0)
    # Compact needed planes to the front of each cell's tail (original
    # order preserved among them); every masked slot after them is a no-op
    # step of the fold.
    K2 = Kt - K1
    score = jnp.where(
        need, -jnp.arange(K2, dtype=fv.dtype)[None], -BIG
    )
    _, ord_idx = jax.lax.top_k(score, K2)
    tail = jnp.take_along_axis(
        cell_planes[:, K1:], ord_idx[..., None], axis=1
    )
    tmask = jnp.take_along_axis(need, ord_idx, axis=1)
    return clip_planes_batch(conv, tail, tmask)


def _split_mesh_islands(conv, mtris, mmask, solid_t, solid_m, mas, cfg,
                        solid_grid=None):
    """CheckMeshIsland (Surtr.cpp:2157-2201) over a candidate batch.

    A candidate whose clipped surface splits into disconnected components
    becomes several pieces sharing the same convex. Runs on pre-cap surface
    triangles; capacity cfg.max_islands per candidate, extra islands stay
    merged with island 0.

    Inputs are batched over candidates (leading axis N): conv/mtris/mmask the
    clipped candidate geometry, solid_t/solid_m the candidate's source solid.

    Capacity design: detection runs on EVERY candidate (cfg.max_islands
    labels tracked per candidate), but secondary islands land in a small
    GLOBAL pool of cfg.island_pool extra candidates — islands are rare, so
    per-candidate slot doubling (round-1 design) wasted 2× the whole
    downstream pipeline. Returns
      (mmask0, x_cand, x_mmask, x_valid):
      * mmask0 (N, T) — candidate masks restricted to the primary island
        (+ merged/overflow islands),
      * x_cand (E,) i32 — source-candidate index of each pool entry,
      * x_mmask (E, T) — the pool entry's island triangles,
      * x_valid (E,) — pool-entry validity.
    Callers append pool entries by gathering their own per-candidate
    bookkeeping at x_cand.
    """
    from surtr_tpu.ops.clip import contains_point
    from surtr_tpu.ops.labels import tri_soup_components

    ISL = max(1, cfg.max_islands)
    N0 = mtris.shape[0]

    # Vertex-coincidence labels run over the clipped SURFACE triangles only.
    # Surface patches of one fragment can connect purely through cut faces
    # (the reference labels the capped polyhedron); distinct surface
    # components are therefore MERGED when the segment between their
    # centroids stays inside (source solid ∩ candidate convex): joined
    # through material → one piece; across a hole (cut torus) → split.
    # Probing the ORIGINAL closed source mesh keeps the ray-parity test
    # robust (round 1 probed an approximate capped mesh and mis-split thin
    # fragments, duplicating convex volume — PARITY.md divergence 3).
    labels = jax.vmap(
        lambda t, m: tri_soup_components(t, m)
    )(mtris, mmask)                                        # (N0, T)
    Tcap = mtris.shape[1] + 1
    lab_valid = jnp.where(mmask, labels, Tcap)
    picks = []
    prev = jnp.full((N0,), -1, jnp.int32)
    for k in range(ISL):
        nxt = jnp.min(
            jnp.where(lab_valid > prev[:, None], lab_valid, Tcap), axis=1
        ).astype(jnp.int32)
        picks.append(nxt)
        prev = nxt
    picks = jnp.stack(picks, axis=1)                       # (N0, ISL)
    sub = lab_valid[:, None, :] == picks[:, :, None]       # (N0, ISL, T)
    # Overflow islands (label beyond the last pick) merge into island 0.
    overflow = lab_valid[:, None, :] > picks[:, -1:, None]
    sub = sub.at[:, 0, :].set(sub[:, 0, :] | overflow[:, 0, :])
    sub = sub & mmask[:, None, :]

    # Material-segment merge test between the primary and each later island:
    # probe 3 points along the centroid segment against the SOURCE solid and
    # the candidate convex; any in-material probe merges the islands.
    tri_cent = jnp.mean(mtris, axis=-2)                    # (N0, T, 3)
    c_all = jax.vmap(
        lambda w, tc: jnp.stack(
            [
                jnp.sum(jnp.where(w[k][:, None], tc, 0.0), axis=0)
                / jnp.maximum(jnp.sum(w[k]), 1)
                for k in range(ISL)
            ]
        )
    )(sub, tri_cent)                                       # (N0, ISL, 3)

    def merge_test(c0, ck, cv, st, sm_):
        probes = jnp.stack(
            [c0 + (ck - c0) * t for t in (0.25, 0.5, 0.75)]
        )                                                  # (3, 3)
        # Winding number, not ray parity: the source piece's capped mesh is
        # only approximately watertight and parity mis-reads interior
        # points, which split fragments and duplicated convex volume.
        # When every candidate shares ONE closed source solid (prepare),
        # the caller passes a precomputed parity grid instead of per-probe
        # winding against a model-scale soup.
        if solid_grid is not None:
            in_solid = parity_grid_inside(solid_grid, probes)
        else:
            in_solid = winding_inside(probes, st, sm_)
        in_conv = jax.vmap(lambda p: contains_point(cv, p, tol=1e-4 * mas))(
            probes
        )
        return jnp.any(in_solid & in_conv)

    # Voxel connectivity (reference parity: CheckMeshIsland labels the
    # CLOSED clipped polyhedron, Surtr.cpp:2157-2201, so patches joined
    # through material around a bend stay one piece): occupancy of a small
    # grid over the candidate hull (in source solid ∩ candidate convex),
    # 6-neighbor label propagation, islands merge when their nearest
    # occupied voxels share a component. Catches C/U-shaped material paths
    # the straight centroid segment leaves (PARITY.md divergence 3); the
    # segment probes stay as a fallback for material thinner than a voxel.
    VR = cfg.island_voxel_res

    def voxel_labels(cv, st, sm_):
        fv = cv.face_verts.reshape(-1, 3)
        fm = cv.slot_mask().reshape(-1)
        big = jnp.asarray(BIG, fv.dtype)
        lo = jnp.min(jnp.where(fm[:, None], fv, big), axis=0)
        hi = jnp.max(jnp.where(fm[:, None], fv, -big), axis=0)
        ext = jnp.maximum(hi - lo, 1e-6)
        ax = (jnp.arange(VR, dtype=fv.dtype) + 0.5) / VR
        gx = lo[0] + ax * ext[0]
        gy = lo[1] + ax * ext[1]
        gz = lo[2] + ax * ext[2]
        pts = jnp.stack(
            jnp.meshgrid(gx, gy, gz, indexing="ij"), axis=-1
        ).reshape(VR * VR * VR, 3)
        if solid_grid is not None:
            in_solid_v = parity_grid_inside(solid_grid, pts)
        else:
            in_solid_v = winding_inside(pts, st, sm_)
        occ = in_solid_v & jax.vmap(
            lambda p: contains_point(cv, p, tol=1e-4 * mas)
        )(pts)
        occ3 = occ.reshape(VR, VR, VR)
        lab = jnp.where(
            occ3,
            jnp.arange(VR**3, dtype=jnp.int32).reshape(VR, VR, VR),
            jnp.int32(VR**3),
        )

        def prop(lab, _):
            def shift(a, d, ax_):
                pad = jnp.full_like(jnp.take(a, jnp.arange(abs(d)), ax_),
                                    VR**3)
                if d > 0:
                    body = jax.lax.slice_in_dim(a, 0, VR - d, axis=ax_)
                    return jnp.concatenate([pad, body], axis=ax_)
                body = jax.lax.slice_in_dim(a, -d, VR, axis=ax_)
                return jnp.concatenate([body, pad], axis=ax_)

            m = lab
            for ax_ in range(3):
                m = jnp.minimum(m, shift(lab, 1, ax_))
                m = jnp.minimum(m, shift(lab, -1, ax_))
            return jnp.where(occ3, jnp.minimum(lab, m), VR**3), None

        lab, _ = jax.lax.scan(prop, lab, None, length=3 * VR)
        return pts, occ, lab.reshape(-1)

    def voxel_label_at(pts, occ, lab, c):
        d2 = jnp.sum((pts - c) ** 2, axis=-1)
        d2 = jnp.where(occ, d2, BIG)
        sel = (d2 <= jnp.min(d2)) & occ
        sel = sel & (jnp.cumsum(sel.astype(jnp.int32)) == 1)
        return jnp.where(
            jnp.any(occ), jnp.sum(jnp.where(sel, lab, 0)), -1
        )

    if VR > 0:
        # Secondary islands are rare: skip the whole voxel-occupancy sweep
        # (winding tests over every candidate) unless some candidate
        # actually produced one this event.
        any_secondary = jnp.any(sub[:, 1:, :])

        def _compute(_):
            # Chunked over candidates: the winding sweep materializes
            # (chunk, VR³, Ts, 3) — a full vmap at 1024 candidates × 10k
            # source tris is a 26 GB tensor (out of device memory).
            return jax.lax.map(
                lambda a: voxel_labels(*a),
                (conv, solid_t, solid_m),
                batch_size=64,
            )

        def _skip(_):
            N0_, G3 = conv.n_verts.shape[0], VR**3
            return (
                jnp.zeros((N0_, G3, 3), jnp.float32),
                jnp.zeros((N0_, G3), bool),
                jnp.full((N0_, G3), VR**3, jnp.int32),
            )

        vox = jax.lax.cond(any_secondary, _compute, _skip, None)

    merged = []
    for k in range(1, ISL):
        exists = jnp.any(sub[:, k, :], axis=-1)
        inside_mid = jax.vmap(merge_test)(
            c_all[:, 0], c_all[:, k], conv, solid_t, solid_m
        )
        if VR > 0:
            l0 = jax.vmap(voxel_label_at)(*vox, c_all[:, 0])
            lk = jax.vmap(voxel_label_at)(*vox, c_all[:, k])
            vox_conn = (l0 >= 0) & (l0 == lk)
        else:
            vox_conn = jnp.zeros_like(exists)
        merged.append(exists & (inside_mid | vox_conn))
    merge_k = jnp.stack(merged, axis=1)                    # (N0, ISL-1)
    # Fold merged islands into island 0; blank their own slot.
    absorbed = jnp.zeros_like(sub[:, 0, :])
    for k in range(1, ISL):
        mk = merge_k[:, k - 1][:, None]
        absorbed = absorbed | (sub[:, k, :] & mk)
        sub = sub.at[:, k, :].set(sub[:, k, :] & ~mk)
    mmask0 = sub[:, 0, :] | absorbed

    # Compact surviving secondary islands into the global pool (stable
    # order: argsort of ~flag keeps first-come entries first).
    E = cfg.island_pool
    T = mtris.shape[1]
    flags = jnp.any(sub[:, 1:, :], axis=-1).reshape(N0 * (ISL - 1))
    order = jnp.argsort(~flags, stable=True)
    take = order[:E]
    x_valid = flags[take]
    x_cand = (take // (ISL - 1)).astype(jnp.int32)
    x_mmask = sub[:, 1:, :].reshape(N0 * (ISL - 1), T)[take] & x_valid[:, None]
    return mmask0, x_cand, x_mmask, x_valid


# ----------------------------------------------------------------------------
# prepare_fracture  (reference stack E)
# ----------------------------------------------------------------------------


def _psum(*trees):
    """Fence helper for profile truncation: sum every leaf to one scalar so
    truncated programs keep all upstream compute live (no DCE)."""
    s = jnp.float32(0)
    for t in trees:
        for a in jax.tree_util.tree_leaves(t):
            s = s + jnp.sum(a.astype(jnp.float32))
    return s


@functools.partial(jax.jit, static_argnames=("cfg", "profile_stage"))
def prepare_fracture(
    verts: jax.Array,
    vmask: jax.Array,
    tri_corners: jax.Array,
    tmask: jax.Array,
    sphere_cloud: jax.Array,
    key: jax.Array,
    cfg: FractureConfig,
    profile_stage: int = 99,
):
    """Initial decomposition of a loaded model into a single compound.

    Returns (PieceSet, FractureContext, metrics dict).

    ``profile_stage`` truncates after stage N for per-phase device timing
    (1=ich/kdop/ach, 2=+cell planes, 3=+patterns, 4=+conv clip, 5=+mesh
    clip, 6=+islands, 7=+finish) returning (fenced scalar, None, None);
    production callers leave the default."""
    F, S = cfg.max_faces, cfg.max_face_verts
    C = cfg.initial_decompose_cell_cnt
    P = cfg.max_pieces
    Tp = cfg.max_piece_tris

    # 1-2. ICH face normals (Surtr.cpp:1750-1755).
    h = ich(verts, vmask, limit=cfg.ich_include_point_limit)

    # 3. Bounding box (Surtr.cpp:1757-1772).
    big = jnp.asarray(BIG, verts.dtype)
    vm = vmask[:, None]
    bb_min = jnp.min(jnp.where(vm, verts, big), axis=0)
    bb_max = jnp.max(jnp.where(vm, verts, -big), axis=0)
    bb_center = (bb_min + bb_max) * 0.5
    extent = bb_max - bb_min
    mas = jnp.max(extent)

    # 4-6. ACH: 2×BB cube clipped by ICH-normal k-DOP slabs
    # (gap = maxAxisScale / ACHPlaneGapInverse, Surtr.cpp:1775-1785).
    planes, pm = kdop_planes(
        verts, vmask, h["normals"], h["face_valid"],
        gap=mas / cfg.ach_plane_gap_inverse,
    )
    ach = translate_poly(
        scale_poly(unit_cube(F=F, S=S, dtype=verts.dtype), extent * 2.0),
        bb_center,
    )
    ach = jax.tree_util.tree_map(
        lambda a: a[0],
        clip_planes_batch(
            jax.tree_util.tree_map(lambda a: a[None], ach),
            planes[None], pm[None],
        ),
    )

    if profile_stage <= 1:
        return _psum(ach), None, None

    # 8. Initial Voronoi decomposition (Surtr.cpp:1798-1803). The cells are
    # only ever consumed as half-space lists, so the one-shot decomposition
    # skips cell construction entirely: per seed, the k-nearest bisectors +
    # the 6 domain planes ARE the cell (redundant half-spaces clip as no-ops).
    # This halves the decomposition cost vs building cell geometry first.
    k0, k1, k2 = jax.random.split(key, 3)
    seeds = uniform_seeds(k0, C)
    kN = min(cfg.voronoi_neighbors, C - 1)
    cell_planes, cell_pmask = _cell_plane_sets(seeds, kN, extent, bb_center)

    if profile_stage <= 2:
        return _psum(ach, cell_planes, cell_pmask), None, None

    # 9. Impact fracture patterns, cached in unit space (Surtr.cpp:1806-1807).
    # Radial clouds are extremely clustered: use all-pairs bisectors (k=None),
    # k-nearest pruning would leave overlapping cells.
    pp = pattern_cells(
        radial_seeds(k1, cfg.partial_pattern_cell_cnt, cfg.partial_pattern_dist),
        k=None, F=F, S=S,
    )
    gp = pattern_cells(
        radial_seeds(k2, cfg.general_pattern_cell_cnt, cfg.general_pattern_dist),
        k=None, F=F, S=S,
    )

    if profile_stage <= 3:
        return _psum(ach, cell_planes, pp, gp), None, None

    ctx = FractureContext(
        bb_center=bb_center,
        bb_min=bb_min,
        bb_max=bb_max,
        max_axis_scale=mas,
        partial_pattern=pp,
        general_pattern=gp,
        sphere_cloud=sphere_cloud,
    )

    # 10. Initial pieces: ACH ∩ cell, mesh ∩ cell (ApplyFracture on the
    # single pre-compound, Surtr.cpp:1810-1811). One batched plane fold
    # over all C cells — two-pass with the
    # radius-bound tail mask (see _two_pass_cell_clip).
    ach_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (C,) + a.shape), ach
    )
    seeds_w = seeds * extent + bb_center
    conv = _two_pass_cell_clip(
        ach_b, cell_planes, cell_pmask, seeds_w, cfg.voronoi_prefix
    )
    if profile_stage <= 4:
        return _psum(conv, cell_planes, pp, gp), None, None

    # Active-plane compaction: the folded cell supports a face on plane k
    # iff its max signed vertex distance is ≥ -tol, and the cell is EXACTLY
    # the intersection of its active half-spaces — so the triangle cull and
    # the soup clip below only need those (measured 12.8 active of 54 at
    # 1k pumpkin cells; the scan length drops 54 → 32). Dead cells get one
    # all-removing plane so their soup clips to nothing. Overflow past the
    # 32-slot cap (never seen; max measured 25) is counted into the drop
    # metric.
    Kt_cell = cell_planes.shape[1]
    KA = min(Kt_cell, 32)
    act_over = jnp.zeros((), jnp.int32)
    if KA < Kt_cell:
        tol_a = jnp.asarray(1e-5, cell_planes.dtype) * mas

        def _active_one(args):
            cv_f, cv_m, pl, pm_ = args
            vf = cv_f.reshape(-1, 3)
            vm_ = cv_m.reshape(-1)
            d = (
                pl[:, 0:1] * vf[None, :, 0]
                + pl[:, 1:2] * vf[None, :, 1]
                + pl[:, 2:3] * vf[None, :, 2]
                + pl[:, 3:4]
            )                                              # (Kt, V)
            smax = jnp.max(jnp.where(vm_[None], d, -BIG), axis=1)
            alive = jnp.any(vm_)
            act = pm_ & (smax > -tol_a) & alive
            score = jnp.where(
                act, -jnp.arange(Kt_cell, dtype=pl.dtype), -BIG
            )
            _, idx = jax.lax.top_k(score, KA)
            sel = pl[idx]
            selm = act[idx]
            # Kill plane for dead cells: d must exceed any triangle
            # bounding radius so the CULL drops their triangles too (at
            # d=1 a big source triangle passed the cull and only died in
            # the clip — wasted pool slots); 1e8 stays far from f32
            # overflow in the clip's edge interpolation products.
            kill = jnp.zeros((KA, 4), pl.dtype).at[0, 3].set(1e8)
            sel = jnp.where(alive, sel, kill)
            selm = jnp.where(
                alive, selm, jnp.zeros((KA,), bool).at[0].set(True)
            )
            return sel, selm, jnp.maximum(jnp.sum(act) - KA, 0)

        cell_planes_a, cell_pmask_a, over = jax.lax.map(
            _active_one,
            (conv.face_verts, conv.slot_mask(), cell_planes, cell_pmask),
            batch_size=128,
        )
        act_over = jnp.sum(over)
    else:
        cell_planes_a, cell_pmask_a = cell_planes, cell_pmask

    # Conservative per-cell triangle culling: at model scale every cell
    # intersects only ~1% of the source mesh, but the naive clip runs all
    # Tsrc triangles against every cell's planes (10k tris × 1024 cells at
    # model scale). A triangle can survive cell c only if
    # no cell plane separates its bounding sphere; survivors compact into
    # a per-cell pool via top-k over (-index) so the clip sees ``cap``
    # candidates instead of Tsrc. Exact for everything kept; pool
    # overflow adds to the drop counter (the usual observable-cap policy).
    Tsrc = tri_corners.shape[0]
    cull_cap = min(Tsrc, max(4 * Tp, -(-6 * Tsrc // max(C, 1))))
    if cull_cap < Tsrc:
        cent_t = jnp.mean(tri_corners, axis=1)                 # (T, 3)
        rad_t = jnp.max(
            jnp.linalg.norm(tri_corners - cent_t[:, None], axis=-1), axis=1
        )
        tol_c = 1e-4 * mas

        def cull_one(args):
            pl, pm_ = args                                     # (Kp,4),(Kp,)
            d = (
                pl[:, 0:1] * cent_t[None, :, 0]
                + pl[:, 1:2] * cent_t[None, :, 1]
                + pl[:, 2:3] * cent_t[None, :, 2]
                + pl[:, 3:4]
            )                                                  # (Kp, T)
            sep = jnp.any(
                (d > rad_t[None, :] + tol_c) & pm_[:, None], axis=0
            )
            keep = tmask & ~sep                                # (T,)
            score = jnp.where(
                keep, -jnp.arange(Tsrc, dtype=jnp.float32), -BIG
            )
            _, idx = jax.lax.top_k(score, cull_cap)
            return idx, keep[idx], jnp.maximum(
                jnp.sum(keep) - cull_cap, 0
            )

        # lax.map applies cull_one per CELL; batch_size only controls the
        # internal vectorization chunk (bounds the (chunk, Kp, T) distance
        # tensor).
        cidx, csel, cull_over = jax.lax.map(
            cull_one, (cell_planes_a, cell_pmask_a), batch_size=128
        )
        if profile_stage == 42:     # sub-profile: active planes + cull
            return _psum(conv, cidx, csel), None, None
        if cfg.mesh_pair_pool:
            # Pair-pool clip: compact the LIVE (cell, tri) pairs into one flat
            # pool and give every pooled polygon its own cell's planes. The
            # per-cell uniform pools wasted ~90% of their slots at model scale
            # (p50 keep ≈ 54 of cull_cap=512) and the vmapped per-cell clip
            # paid for all of them. Pool capacity is the usual observable cap
            # (overflow counted into the drop metric); pairs stay grouped by
            # cell, so per-cell outputs are contiguous runs of the pool.
            from surtr_tpu.ops.linalg import pack_rows
            from surtr_tpu.ops.mesh_clip import clip_polys_by_rows, fan_triangles

            kept_cnt = jnp.sum(csel, axis=1).astype(jnp.int32)     # (C,)
            # Pool sized for the MEASURED occupancy, not the worst case: a
            # triangle lands in ~2-3 cells (pumpkin 1k: ~25k live pairs),
            # so 4·Tsrc is ~1.6× headroom — a 16·Tsrc pool made the pack
            # gathers move 84% dead slots. Overflow stays observable
            # (pair_over below) like every other capacity.
            PAIR_CAP = int(min(C * cull_cap, max(4 * Tsrc, 1 << 15)))
            cell_ids = jnp.broadcast_to(
                jnp.arange(C, dtype=jnp.int32)[:, None], (C, cull_cap)
            )
            pairs, pair_total = pack_rows(
                jnp.stack([cell_ids, cidx], axis=-1), kept_cnt, PAIR_CAP
            )                                                      # (PC, 2)
            pair_over = jnp.maximum(jnp.sum(kept_cnt) - pair_total, 0)
            pair_cell = jnp.clip(pairs[:, 0], 0, C - 1)
            pair_tri = jnp.clip(pairs[:, 1], 0, Tsrc - 1)
            pair_valid = jnp.arange(PAIR_CAP, dtype=jnp.int32) < pair_total
            pstart = jnp.minimum(
                jnp.concatenate(
                    [jnp.zeros((1,), jnp.int32), jnp.cumsum(kept_cnt)]
                ),
                PAIR_CAP,
            )                                                      # (C+1,)

            if profile_stage == 43:  # sub-profile: pair pack + gathers
                return _psum(
                    conv, tri_corners[pair_tri],
                    cell_planes_a[pair_cell], cell_pmask_a[pair_cell],
                ), None, None
            poly, nvp, mrun_drops = clip_polys_by_rows(
                tri_corners[pair_tri], pair_valid,
                cell_planes_a[pair_cell], cell_pmask_a[pair_cell],
                seg_starts=pstart, seg_id=pair_cell,
            )
            if profile_stage == 44:  # sub-profile: pooled clip fold
                return _psum(conv, poly, nvp, mrun_drops), None, None
            fans, fcnt = fan_triangles(poly, nvp)                  # (PC,S,3,3)

            # Per-cell Tp clamp BEFORE the global pack: a pair may emit only
            # into its cell's remaining budget, so the packed stream holds at
            # most Tp fans per cell and no cell can starve another.
            cumf = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(fcnt)]
            )                                                      # (PC+1,)
            cellbase = cumf[pstart]                                # (C+1,)
            off = cumf[:-1] - cellbase[pair_cell]                  # (PC,)
            allowed = jnp.clip(Tp - off, 0, fcnt)
            fan_drop = jnp.sum(fcnt * pair_valid) - jnp.sum(allowed * pair_valid)
            Sfan = fans.shape[1]
            packed, _ftot = pack_rows(
                fans.reshape(PAIR_CAP, Sfan, 9), allowed, C * Tp
            )
            cuma = jnp.concatenate(
                [jnp.zeros((1,), jnp.int32), jnp.cumsum(allowed)]
            )
            fanbase = cuma[pstart]                                 # (C+1,)
            cellfan = fanbase[1:] - fanbase[:-1]                   # (C,) ≤ Tp
            slot_t = jnp.arange(Tp, dtype=jnp.int32)
            idx = jnp.clip(fanbase[:-1, None] + slot_t[None], 0, C * Tp - 1)
            mmask = slot_t[None, :] < cellfan[:, None]
            mtris = jnp.where(
                mmask[..., None, None], packed[idx].reshape(C, Tp, 3, 3), 0.0
            )
            # cull_over is per-cell (C,) — collapse it, the rest are
            # scalars (a broadcast here summed the scalars C times).
            mdrop = (
                jnp.sum(cull_over) + act_over + pair_over + fan_drop
                + mrun_drops
            )
        else:  # per-cell uniform pools (equivalence fallback)
            ctris = tri_corners[cidx]                          # (C,cap,3,3)
            mtris, mmask, mdrop = jax.vmap(
                lambda ct, cm_, pl, pm_: clip_trisoup(
                    ct, cm_, pl, pm_, max_out=Tp
                )
            )(ctris, csel, cell_planes_a, cell_pmask_a)
            mdrop = mdrop + cull_over + act_over
    else:
        def mesh_one(pl, pm_):
            return clip_trisoup(tri_corners, tmask, pl, pm_, max_out=Tp)

        mtris, mmask, mdrop = jax.vmap(mesh_one)(cell_planes_a, cell_pmask_a)
        mdrop = mdrop + act_over

    if profile_stage <= 5:
        return _psum(conv, mtris, mmask, mdrop, pp, gp), None, None

    solid_t = jnp.broadcast_to(tri_corners[None], (C,) + tri_corners.shape)
    solid_m = jnp.broadcast_to(tmask[None], (C,) + tmask.shape)

    # Prepare-time island check (the reference's ApplyFracture runs
    # CheckMeshIsland during initial decomposition too, Surtr.cpp:1810-1814):
    # a cell of a non-convex model can clip into disjoint chunks.
    cpl, cpm = cell_planes_a, cell_pmask_a
    cand_ok = jnp.ones((C,), bool)
    # Every candidate shares the one closed SOURCE solid here, so the
    # inside-solid queries (island merge tests AND exact-cap probes) sample
    # a precomputed parity grid instead of per-query winding numbers. The
    # build costs ~R²·T·R compares —
    # only worth it when the query volume (candidates × probes × source
    # tris) dwarfs it; tiny sources / few cells keep the exact winding path.
    Tsrc_i = tri_corners.shape[0]
    use_grid = cfg.island_grid_res > 0 and C >= 64 and Tsrc_i >= 512
    solid_grid = (
        build_parity_grid(tri_corners, tmask, res=cfg.island_grid_res)
        if use_grid
        else None
    )
    if cfg.max_islands > 1 and cfg.island_pool > 0:
        mmask0, x_cand, x_mmask, x_valid = _split_mesh_islands(
            conv, mtris, mmask, solid_t, solid_m, mas, cfg,
            solid_grid=solid_grid,
        )
        g = lambda a: a[x_cand]
        conv = jax.tree_util.tree_map(
            lambda a: jnp.concatenate([a, a[x_cand]]), conv
        )
        mtris = jnp.concatenate([mtris, g(mtris)])
        mmask = jnp.concatenate([mmask0, x_mmask])
        cpl = jnp.concatenate([cell_planes, g(cell_planes)])
        cpm = jnp.concatenate([cell_pmask, g(cell_pmask)])
        solid_t = jnp.concatenate([solid_t, g(solid_t)])
        solid_m = jnp.concatenate([solid_m, g(solid_m)])
        cand_ok = jnp.concatenate([cand_ok, x_valid])

    if profile_stage <= 6:
        return _psum(conv, mtris, mmask, cand_ok, pp, gp), None, None

    out = _finish_pieces(
        conv, mtris, mmask, cpl, cpm, solid_t, solid_m, mas, cfg,
        solid_grid=solid_grid,
        profile_stage=profile_stage if 45 <= profile_stage <= 49 else 99,
    )
    if 45 <= profile_stage <= 49:  # finish sub-profile: out is the fence
        return out, None, None
    conv, mtris, mmask, cand_valid, cap_drop = out
    # mdrop may be per-cell (C,) on the non-pooled paths — collapse first.
    mdrop = jnp.sum(mdrop) + cap_drop
    cand_valid = cand_valid & cand_ok
    N = cand_valid.shape[0]

    if profile_stage <= 7:
        return _psum(conv, mtris, mmask, cand_valid, pp, gp), None, None

    # Pack into the PieceSet pool (group 0 — one initial compound).
    vol, _ = moments(conv)
    pieces = _pack_candidates(
        conv, mtris, mmask, cand_valid,
        jnp.zeros((N,), jnp.int32), jnp.full((N,), -1, jnp.int32),
        vol, P, Tp, F, S,
    )

    metrics = {
        "ich_face_cnt": jnp.sum(h["face_valid"]),
        "piece_cnt": jnp.sum(cand_valid),
        "total_volume": jnp.sum(jnp.where(cand_valid, vol, 0.0)),
        "mesh_tris_dropped": jnp.sum(mdrop),
    }
    return pieces, ctx, metrics


def _finish_pieces(
    conv, mtris, mmask, cut_planes, cut_mask, solid_corners, solid_mask, mas,
    cfg, solid_grid=None, profile_stage: int = 99,
):
    """Shared tail of both fracture entry points: occupancy test, refit,
    cap generation. All inputs batched over candidates (leading axis);
    cut_planes/cut_mask are the half-spaces that produced each candidate
    ((N, Kc, 4) / (N, Kc)); solid_corners/solid_mask are per-candidate source
    solids ((N, Ts, 3, 3) / (N, Ts)). ``solid_grid``: optional precomputed
    inside-solid parity grid when every candidate shares one source solid
    (prepare) — used by the exact-caps probes.

    The refit clip runs as ONE batched plane fold — per-candidate work
    around it stays vmapped.

    Returns (conv2, mtris2, mmask2, cand_valid, cap_dropped)."""
    F, S = cfg.max_faces, cfg.max_face_verts

    # Occupancy: surface triangles present, or convex centroid inside the
    # source solid (interior cells — the analogue of the reference's
    # closed-polyhedron clip staying non-empty). With a shared source
    # solid the parity grid answers the centroid query for the cost of one
    # tiny gather (the vmapped ray test is N·Tsrc ray-tri ops — ~90 M at
    # pumpkin scale).
    has_tris = jnp.any(mmask, axis=-1)
    _, cent = moments(conv)
    if solid_grid is not None:
        inside = parity_grid_inside(solid_grid, cent)
    else:
        inside = jax.vmap(lambda c, t, m: point_in_mesh(c[None], t, m)[0])(
            cent, solid_corners, solid_mask
        )
    cand_valid = ~conv.is_empty() & (has_tris | inside)
    if profile_stage == 45:  # sub-profile: occupancy only
        return _psum(conv, mtris, mmask, cand_valid)

    cap_dropped = jnp.int32(0)
    if cfg.exact_caps:
        # Exact closed-mesh caps (reference Poly.cpp:265-554 semantics):
        # cap = pre-refit convex cut face ∩ solid cross-section, and the
        # refit pool gets only TRUE-boundary cap vertices — together these
        # close the concave-model parity gap (PARITY.md divergence 1).
        from surtr_tpu.ops.caps import cap_fans_batch

        cap_rows, cap_ok, cap_pv, cap_pm, cap_dropped = cap_fans_batch(
            conv, mtris, mmask, cut_planes, cut_mask,
            solid_corners, solid_mask, mas, cfg, solid_grid=solid_grid,
        )
        N = mtris.shape[0]
        pool = jnp.concatenate([mtris.reshape(N, -1, 3), cap_pv], axis=1)
        pool_m = jnp.concatenate(
            [jnp.repeat(mmask, 3, axis=1), cap_pm], axis=1
        )
    else:
        # Legacy pool: clipped surface corners + pre-refit cut-face verts
        # (overshoots on concave models — kept for A/B measurement).
        def pool_one(cv, tris, tmask_, planes_, pmask_):
            cut_sel = _match_cut_faces(cv, planes_, pmask_, mas)
            cap_v = cv.face_verts.reshape(-1, 3)
            cap_m = (cv.slot_mask() & cut_sel[:, None]).reshape(-1)
            surf_v = tris.reshape(-1, 3)
            surf_m = jnp.repeat(tmask_, 3)
            return (
                jnp.concatenate([surf_v, cap_v]),
                jnp.concatenate([surf_m, cap_m]),
            )

        pool, pool_m = jax.vmap(pool_one)(
            conv, mtris, mmask, cut_planes, cut_mask
        )

    slabs, slab_m = jax.vmap(
        lambda v, m: refit_planes(v, m, cfg.refitting_point_limit)
    )(pool, pool_m)
    if profile_stage == 46:  # sub-profile: + pool build + refit planes
        return _psum(conv, mtris, mmask, cand_valid, slabs, slab_m)
    conv2 = clip_planes_batch(conv, slabs, slab_m)
    if profile_stage == 47:  # sub-profile: + refit clip fold
        return _psum(conv2, mtris, mmask, cand_valid)

    if cfg.exact_caps:
        def caps_append(tris, tmask_, rows, ok):
            tris2, tmask2, drop = _append_tris(
                tris, tmask_, rows[:, None], ok.astype(jnp.int32)
            )
            return tris2, tmask2, drop

        mtris2, mmask2, app_drop = jax.vmap(caps_append)(
            mtris, mmask, cap_rows, cap_ok
        )
        cap_dropped = cap_dropped + jnp.sum(app_drop)
    else:
        # Caps from the refit convex's cut faces.
        def caps_one(refit, tris, tmask_, planes_, pmask_):
            cut2 = _match_cut_faces(refit, planes_, pmask_, mas)
            cap_rows, cap_counts = cut_face_tris(refit, cut2)
            tris2, tmask2, drop = _append_tris(
                tris, tmask_, cap_rows, cap_counts
            )
            return tris2, tmask2, drop

        mtris2, mmask2, app_drop = jax.vmap(caps_one)(
            conv2, mtris, mmask, cut_planes, cut_mask
        )
        cap_dropped = cap_dropped + jnp.sum(app_drop)

    # Invalidate empties — including pieces whose convex the refit clip
    # itself collapsed (a sliver's refit slabs can be mutually exclusive):
    # cand_valid was computed on the PRE-refit conv, and a valid piece with
    # an empty hull becomes a zero-mass static body that swallows every
    # scene-query ray at t=0 (measured: 14 phantom pieces after one
    # interactive-frame event froze all subsequent scripted impacts).
    cand_valid = cand_valid & ~conv2.is_empty()
    nv = jnp.where(cand_valid[:, None], conv2.n_verts, 0)
    conv2 = ConvexPoly(conv2.face_verts, nv, conv2.planes)
    mmask2 = mmask2 & cand_valid[:, None]
    return conv2, mtris2, mmask2, cand_valid, cap_dropped


def _pack_candidates(conv, mtris, mmask, valid, group, tag, vol, P, Tp, F, S):
    """Compact candidates into a fresh PieceSet of capacity P, keeping the
    top-volume pieces on overflow."""
    C = valid.shape[0]
    score = jnp.where(valid, vol, -1.0)
    order = jnp.argsort(-score)  # best first
    take = order[: min(P, C)]
    sel_valid = valid[take]
    if C < P:
        pad = P - C
        sel_valid = jnp.concatenate([sel_valid, jnp.zeros((pad,), bool)])
        take = jnp.concatenate([take, jnp.zeros((pad,), jnp.int32)])
    gather = lambda a: a[take]
    return PieceSet(
        convex=ConvexPoly(
            gather(conv.face_verts),
            jnp.where(sel_valid[:, None], gather(conv.n_verts), 0),
            gather(conv.planes),
        ),
        mesh=gather(mtris),
        mesh_valid=gather(mmask) & sel_valid[:, None],
        valid=sel_valid,
        group=jnp.where(sel_valid, gather(group), -1),
        tag=jnp.where(sel_valid, gather(tag), -1),
    )


# ----------------------------------------------------------------------------
# do_fracture  (reference stack D)
# ----------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("cfg", "partial", "profile_stage")
)
def do_fracture(
    pieces: PieceSet,
    ctx: FractureContext,
    impact_pos: jax.Array,
    target_group,
    cfg: FractureConfig,
    partial: bool = True,
    profile_stage: int = 99,
):
    """Refracture compounds at an impact point. Returns (PieceSet, metrics).

    ``target_group`` is either a scalar group id or a (P,) boolean PIECE mask
    selecting several compounds at once — a radial impact fractures every
    affected body in ONE dispatch (the reference fans out per body on the
    host, Surtr.cpp:251-253).

    partial=True uses the 128-cell impact-local pattern and leaves
    out-of-sphere pieces attached to their parent compound (bind[0]
    semantics); partial=False uses the 1024-cell general pattern on every
    piece.
    """
    F, S = cfg.max_faces, cfg.max_face_verts
    A = cfg.max_active_pieces
    P = cfg.max_pieces
    Tp = cfg.max_piece_tris
    mas = ctx.max_axis_scale

    pattern = ctx.partial_pattern if partial else ctx.general_pattern
    C = pattern.n_verts.shape[0]

    # Scale pattern ×(2·maxAxisScale), translate to impact (Surtr.cpp:1887-96).
    cells = translate_poly(scale_poly(pattern, 2.0 * mas), impact_pos)
    cloud = ctx.sphere_cloud * cfg.impact_radius + impact_pos

    target_group = jnp.asarray(target_group)
    if target_group.ndim == 0:
        target_mask = pieces.group == target_group.astype(jnp.int32)
    else:
        target_mask = target_group
    in_target = pieces.valid & target_mask
    if partial:
        outside = convex_out_of_sphere(
            pieces.convex, cloud, impact_pos, cfg.impact_radius
        )
    else:
        outside = jnp.zeros_like(pieces.valid)
    active = in_target & ~outside

    # Select up to A active pieces (largest first; overflow stays unfractured).
    vol0, _ = moments(pieces.convex)
    score = jnp.where(active, vol0, -1.0)
    order = jnp.argsort(-score)
    sel = order[:A]
    sel_ok = active[sel]
    active_overflow = jnp.maximum(jnp.sum(active) - A, 0)

    selected = jnp.zeros((pieces.P,), bool).at[sel].set(sel_ok)

    src_conv = jax.tree_util.tree_map(lambda a: a[sel], pieces.convex)
    src_mesh = pieces.mesh[sel]
    src_mmask = pieces.mesh_valid[sel] & sel_ok[:, None]

    # --- ApplyFracture: A × C grid clip (Surtr.cpp:2129-2146), flattened to
    # one batched plane fold.
    N0 = A * C
    # Pre-fold job cull (partial mode): job (a, c) can be non-empty only if
    # NO cell plane separates piece a's bounding sphere from cell c — exact,
    # since the cell IS the intersection of its half-spaces (false keeps
    # fold to empty as before; false drops are impossible). The clustered
    # partial pattern leaves ~3% of the grid alive on a first impact (cube32
    # measured 2.6%), so folding only a JPOOL pool halves the batched fold.
    # Repeated clicks at one spot hit many small pieces at once: at the
    # reference settings (A=32, C=128) a second click keeps ~1.4k jobs
    # alive, and a smaller pool drops real fragments. General mode
    # keeps the full grid (wide patterns overlap many cells and the
    # pre-cull's index-order overflow priority is worse than the post-fold
    # volume-order compaction).
    JPOOL = min(N0, max(256, N0 // 2)) if partial else N0
    if JPOOL < N0:
        fvs = src_conv.face_verts                          # (A, F, S, 3)
        smA = src_conv.slot_mask()
        cntA = jnp.maximum(jnp.sum(smA, axis=(1, 2)), 1)
        centA = (
            jnp.sum(jnp.where(smA[..., None], fvs, 0.0), axis=(1, 2))
            / cntA[:, None]
        )                                                  # (A, 3)
        radA = jnp.sqrt(
            jnp.max(
                jnp.where(
                    smA,
                    jnp.sum((fvs - centA[:, None, None]) ** 2, -1),
                    0.0,
                ),
                axis=(1, 2),
            )
        )                                                  # (A,)
        distAC = (
            jnp.sum(
                cells.planes[None, :, :, :3] * centA[:, None, None, :], -1
            )
            + cells.planes[None, :, :, 3]
        )                                                  # (A, C, F)
        sepAC = jnp.any(
            cells.face_mask()[None]
            & (distAC > radA[:, None, None] + 1e-5 * mas),
            axis=-1,
        )
        alive0 = (
            sel_ok[:, None] & ~sepAC & ~cells.is_empty()[None]
        ).reshape(N0)
        score0 = jnp.where(
            alive0, -jnp.arange(N0, dtype=jnp.float32), -BIG
        )
        _, jsel = jax.lax.top_k(score0, JPOOL)             # ascending index
        jsel_ok = alive0[jsel]
        precull_over = jnp.maximum(jnp.sum(alive0) - JPOOL, 0)
    else:
        jsel = jnp.arange(N0, dtype=jnp.int32)
        jsel_ok = jnp.repeat(sel_ok, C)
        precull_over = jnp.int32(0)
    a_of = (jsel // C).astype(jnp.int32)
    c_of = (jsel % C).astype(jnp.int32)
    src_rep = jax.tree_util.tree_map(lambda a: a[a_of], src_conv)
    cell_planes_t = cells.planes[c_of]
    cell_pmask_t = cells.face_mask()[c_of]
    conv = clip_planes_batch(src_rep, cell_planes_t, cell_pmask_t)
    # clip_poly_poly semantics: empty clipper → empty result; culled or
    # unselected jobs are empty too.
    conv = ConvexPoly(
        conv.face_verts,
        jnp.where(jsel_ok[:, None], conv.n_verts, 0),
        conv.planes,
    )

    if profile_stage <= 1:  # selection + pre-cull + convex clip grid
        return _psum(conv, src_mesh, src_mmask), None

    # --- job compaction: the grid pool is mostly DEAD after the convex fold
    # — keep the largest JCAP live jobs so the mesh clip, island labeling,
    # and finish stages run on a small pool. Overflow drops the smallest
    # fragments and is counted (the usual observable-cap policy). The
    # general pattern spreads wide, so its cap is looser.
    alive_job = ~conv.is_empty() & jsel_ok
    JCAP = min(JPOOL, max(128, N0 // (4 if partial else 2)))
    volj, _ = moments(conv)
    scorej = jnp.where(alive_job, volj, -1.0)
    jtake = jnp.argsort(-scorej)[:JCAP]
    jvalid = alive_job[jtake]
    conv = jax.tree_util.tree_map(lambda a: a[jtake], conv)
    cell_of = c_of[jtake]
    src_of = a_of[jtake]
    src_valid = jvalid
    job_overflow = (
        jnp.maximum(jnp.sum(alive_job) - JCAP, 0) + precull_over
    )

    # Mesh clip on the live-job pool only.
    jmesh = src_mesh[src_of]
    jmmask = src_mmask[src_of] & jvalid[:, None]
    jcpl = cells.planes[cell_of]
    jcpm = cells.face_mask()[cell_of]
    mtris, mmask, mdrop = jax.vmap(
        lambda me, mm, pl, pm_: clip_trisoup(me, mm, pl, pm_, max_out=Tp)
    )(jmesh, jmmask, jcpl, jcpm)

    if profile_stage <= 2:  # + mesh clip
        return _psum(conv, mtris, mmask, mdrop), None

    # --- CheckMeshIsland (Surtr.cpp:2157-2201): a candidate whose clipped
    # surface splits into disconnected components becomes several pieces
    # sharing the same convex (refit later shrinks each to its own island's
    # mesh, Surtr.cpp:1470-1496).
    if cfg.max_islands > 1 and cfg.island_pool > 0:
        mmask0, x_cand, x_mmask, x_valid = _split_mesh_islands(
            conv, mtris, mmask,
            src_mesh[src_of], src_mmask[src_of], mas, cfg,
        )
        conv = jax.tree_util.tree_map(
            lambda a: jnp.concatenate([a, a[x_cand]]), conv
        )
        mtris = jnp.concatenate([mtris, mtris[x_cand]])
        mmask = jnp.concatenate([mmask0, x_mmask])
        cell_of = jnp.concatenate([cell_of, cell_of[x_cand]])
        src_of = jnp.concatenate([src_of, src_of[x_cand]])
        src_valid = jnp.concatenate([src_valid, src_valid[x_cand] & x_valid])
    N = conv.n_verts.shape[0]
    if profile_stage <= 3:  # + mesh islands
        return _psum(conv, mtris, mmask, src_valid), None
    cplanes_flat = cells.planes[cell_of]
    cpmask_flat = cells.face_mask()[cell_of]

    # Occupancy / refit / caps against each candidate's *source piece* solid.
    out = _finish_pieces(
        conv, mtris, mmask, cplanes_flat, cpmask_flat,
        src_mesh[src_of], src_mmask[src_of], mas, cfg,
        profile_stage=profile_stage,
    )
    if 41 <= profile_stage <= 49:  # finish sub-profile: out is the fence
        return out, None
    conv2, mtris2, mmask2, cand_valid, cap_drop = out
    mdrop = jnp.sum(mdrop) + cap_drop
    cand_valid = cand_valid & src_valid
    if profile_stage <= 4:  # + finish (occupancy/refit/caps)
        return _psum(conv2, mtris2, mmask2, cand_valid), None

    # --- MergeOutOfImpact (Surtr.cpp:2368-2403): partial-mode candidates
    # fully outside the sphere rejoin the parent compound.
    if partial:
        cand_out = convex_out_of_sphere(
            conv2, cloud, impact_pos, cfg.impact_radius
        )
    else:
        cand_out = jnp.zeros((N,), bool)

    # Provisional groups: parent group for merged candidates, else a fresh
    # id per (parent compound, cell) (bind-per-cell, Surtr.cpp:2139-2145;
    # the parent axis keeps simultaneous multi-body fractures from gluing
    # fragments of different bodies into one compound).
    gmax = jnp.max(jnp.where(pieces.valid, pieces.group, 0))
    src_groups = pieces.group[sel]                             # (A,)
    parent_of = src_groups[src_of]                             # (N,)
    cand_group = jnp.where(
        cand_out, parent_of, gmax + 1 + parent_of * C + cell_of
    ).astype(jnp.int32)

    # --- merge candidate pool with surviving original pieces, compact to P.
    # Only the pieces actually fractured are consumed; active pieces beyond
    # the top-A selection stay intact (counted in active_overflow).
    keep_orig = pieces.valid & ~selected
    vol_new, _ = moments(conv2)
    all_conv = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), pieces.convex, conv2
    )
    all_mesh = jnp.concatenate([pieces.mesh, mtris2])
    all_mmask = jnp.concatenate(
        [pieces.mesh_valid & keep_orig[:, None], mmask2]
    )
    all_valid = jnp.concatenate([keep_orig, cand_valid])
    all_group = jnp.concatenate([pieces.group, cand_group])
    all_tag = jnp.concatenate(
        [pieces.tag, jnp.full((N,), -1, jnp.int32)]
    )
    all_vol = jnp.concatenate([jnp.where(keep_orig, vol0, -1.0), vol_new])

    packed = _pack_candidates(
        all_conv, all_mesh, all_mmask, all_valid, all_group, all_tag, all_vol,
        P, Tp, F, S,
    )
    piece_overflow = jnp.maximum(jnp.sum(all_valid) - P, 0)
    if profile_stage <= 5:  # + merge/group/pack
        return _psum(packed.valid, packed.convex, piece_overflow), None

    # --- HandleConvexIsland (Surtr.cpp:2203-2366): split every compound into
    # contact-connected components.
    packed, split_overflow = split_groups_by_contact(
        packed, eps=1e-3 * mas, exact=cfg.exact_face_overlap
    )

    metrics = {
        "split_face_overflow": split_overflow,
        "active_pieces": jnp.sum(active),
        "active_overflow": active_overflow,
        "job_overflow": job_overflow,
        "new_pieces": jnp.sum(cand_valid),
        "piece_overflow": piece_overflow,
        "merged_out": jnp.sum(cand_out & cand_valid),
        "total_volume": jnp.sum(jnp.where(packed.valid, moments(packed.convex)[0], 0.0)),
        "mesh_tris_dropped": jnp.sum(mdrop),
        "num_groups": packed.num_groups(),
    }
    return packed, metrics


# ----------------------------------------------------------------------------
# HandleConvexIsland
# ----------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("exact",))
def split_groups_by_contact(pieces: PieceSet, eps, exact: bool = False):
    """Split every compound (group) into face-contact-connected components.
    Returns (PieceSet, split_overflow) — the overflow counts contact faces
    beyond the exact-SAT face pool (0 on the non-exact path).

    Contact test: a pair of pieces touches iff they own *opposite, coplanar*
    faces (cut faces share planes bitwise) whose bounding spheres overlap —
    the batched analogue of the reference's AbsD-sorted coplanar scan +
    point-in-polygon check (Surtr.cpp:2240-2325; the sphere test is
    conservative toward keeping contact). With ``exact=True`` sphere-passing
    pairs are refined by an exact 2-D SAT overlap of the coplanar polygons
    (top-4 candidate partners per face), matching the reference's exact scan.
    Components then relabel ``group`` (flood fill, Surtr.cpp:2325-2352).

    Layout: a piece-level candidate prune (same group + bounding-sphere
    proximity, nearest-first top-KP) runs at (P, P), then the face chain
    runs only against the KP candidate pieces: (P·F, KP, F) with every term
    elementwise and the partner-face axis min-reduced INSIDE one fused
    chain — a convex piece owns at most one real face on a given plane, so
    "nearest opposite-coplanar face of partner j" is exact. The all-pairs
    face table would hold (P·F)² ≈ 67M entries at the interactive-frame
    pool; the KP prune cuts the (P·F, P, F) chain's element count ~5×.
    The prune is
    conservative (threshold 2·(r_i+r_j) covers face-sphere contact through
    non-centered faces); candidate overflow beyond KP drops the FARTHEST
    pieces only.
    """
    P, F = pieces.P, pieces.convex.F
    planes = pieces.convex.planes  # (P, F, 4)
    fmask = pieces.convex.face_mask() & pieces.valid[:, None]

    # Face centroids and radii.
    sm = pieces.convex.slot_mask()[..., None]
    nv = jnp.maximum(pieces.convex.n_verts, 1)[..., None]
    cent = jnp.sum(jnp.where(sm, pieces.convex.face_verts, 0.0), axis=-2) / nv
    r2 = jnp.max(
        jnp.where(
            sm[..., 0],
            jnp.sum((pieces.convex.face_verts - cent[..., None, :]) ** 2, -1),
            0.0,
        ),
        axis=-1,
    )  # (P, F)

    pf = P * F
    n_flat = planes[..., :3].reshape(pf, 3)
    m_flat = fmask.reshape(pf)
    owner = jnp.repeat(jnp.arange(P, dtype=jnp.int32), F)

    # ---- piece-level candidate prune: same group, valid, spheres near.
    # KP=32 covers Voronoi-fragment contact degree (~10-15 face partners)
    # with 2x headroom; candidates are distance-ordered so overflow drops
    # the farthest pieces only.
    KP = min(32, P)
    pidx_all = jnp.arange(P, dtype=jnp.int32)
    psm = pieces.convex.slot_mask()                          # (P, F, S)
    pcnt = jnp.maximum(jnp.sum(psm, axis=(1, 2)), 1)
    pcent = (
        jnp.sum(
            jnp.where(psm[..., None], pieces.convex.face_verts, 0.0),
            axis=(1, 2),
        )
        / pcnt[:, None]
    )                                                        # (P, 3)
    pr = jnp.sqrt(
        jnp.max(
            jnp.where(
                psm,
                jnp.sum(
                    (pieces.convex.face_verts - pcent[:, None, None]) ** 2,
                    -1,
                ),
                0.0,
            ),
            axis=(1, 2),
        )
    )                                                        # (P,)
    pd2 = jnp.sum((pcent[:, None] - pcent[None, :]) ** 2, -1)  # (P, P)
    cand_ok = (
        (pieces.group[:, None] == pieces.group[None, :])
        & pieces.valid[:, None]
        & pieces.valid[None, :]
        & (pidx_all[:, None] != pidx_all[None, :])
        & (pd2 <= (2.0 * (pr[:, None] + pr[None, :]) + eps) ** 2)
    )
    _, part = jax.lax.top_k(jnp.where(cand_ok, -pd2, -BIG), KP)  # (P, KP)
    part = part.astype(jnp.int32)
    part_ok = jnp.take_along_axis(cand_ok, part, axis=1)     # (P, KP)

    # Partner face tables, gathered once per candidate piece.
    planes_k = planes[part]                                  # (P, KP, F, 4)
    cent_k = cent[part]                                      # (P, KP, F, 3)
    rj_k = jnp.sqrt(r2)[part]                                # (P, KP, F)
    fmask_k = fmask[part]                                    # (P, KP, F)

    # Best (nearest) opposite-coplanar-near face of EACH candidate piece,
    # per own face: fused (P, F, KP, F) chain min-reduced over the partner-
    # face axis (never materialized).
    n_own = planes[..., :3]                                  # (P, F, 3)
    d_own = planes[..., 3]                                   # (P, F)
    r_own = jnp.sqrt(r2)
    ndot = jnp.einsum(
        "pfx,pkgx->pfkg", n_own, planes_k[..., :3],
        precision=jax.lax.Precision.HIGHEST,
    )                                                        # (P, F, KP, F)
    opp = jnp.abs(ndot + 1.0) < 1e-4
    cop = (
        jnp.abs(d_own[:, :, None, None] + planes_k[..., 3][:, None]) < eps
    )
    cd2 = (
        (cent[..., 0][:, :, None, None] - cent_k[..., 0][:, None]) ** 2
        + (cent[..., 1][:, :, None, None] - cent_k[..., 1][:, None]) ** 2
        + (cent[..., 2][:, :, None, None] - cent_k[..., 2][:, None]) ** 2
    )
    near_g = cd2 <= (
        r_own[:, :, None, None] + rj_k[:, None] + eps
    ) ** 2
    score_g = jnp.where(
        opp & cop & near_g & fmask_k[:, None], cd2, BIG
    )                                                        # (P, F, KP, F)
    bdist = jnp.min(score_g, axis=-1).reshape(pf, KP)        # (pf, KP)
    bface = jnp.argmin(score_g, axis=-1).astype(jnp.int32).reshape(pf, KP)

    pair_ok = (
        (bdist < BIG / 2)
        & m_flat[:, None]
        & jnp.repeat(part_ok, F, axis=0).reshape(pf, KP)
    )                                                        # (pf, KP)
    part_flat = jnp.repeat(part, F, axis=0).reshape(pf, KP)  # owner-tiled

    if exact:
        # Refine sphere-passing pairs with an exact 2-D SAT overlap of the
        # coplanar face polygons (top-4 candidate partner pieces per face;
        # a convex partner contributes at most one opposite face on a
        # plane, so partner-level top-4 covers the old face-level top-4).
        # The SAT runs on a packed FACE pool: only faces with ≥1 surviving
        # candidate participate (~10-25% of the pf slots on real events).
        # Pool overflow drops the HIGHEST face
        # slots (stable order) and is returned as split_overflow.
        K4 = min(4, KP)
        S = pieces.convex.S
        has_cand = jnp.any(pair_ok, axis=1)                 # (pf,)
        FPOOL = min(pf, max(1024, pf // 4))
        forder = jnp.argsort(
            jnp.where(has_cand, 0, 1).astype(jnp.int32), stable=True
        )
        fsel = forder[:FPOOL]
        fok = has_cand[fsel]
        split_overflow = jnp.sum(has_cand) - jnp.sum(fok)
        pair_ok_p = pair_ok[fsel] & fok[:, None]            # (FPOOL, KP)
        score = jnp.where(pair_ok_p, -bdist[fsel], -BIG)    # (FPOOL, KP)
        _, candk = jax.lax.top_k(score, K4)                 # (FPOOL, K4)
        cmask = jnp.take_along_axis(pair_ok_p, candk, axis=1)
        candp = jnp.take_along_axis(
            part_flat[fsel], candk, axis=1
        )                                                   # piece ids
        cand = candp * F + jnp.take_along_axis(
            bface[fsel], candk, axis=1
        )
        fv_flat = pieces.convex.face_verts.reshape(pf, S, 3)
        nv_flat = pieces.convex.n_verts.reshape(pf)

        def pair_overlap(i):
            """(K4,) exact overlaps of pooled face i vs its candidates."""
            from surtr_tpu.ops.clip import plane_basis

            ni = n_flat[fsel[i]]
            u, v = plane_basis(ni)
            ai = fv_flat[fsel[i]]                           # (S, 3)
            mi = jnp.arange(S) < nv_flat[fsel[i]]
            a2 = jnp.stack(
                [jnp.sum(ai * u, -1), jnp.sum(ai * v, -1)], axis=-1
            )                                               # (S, 2)
            bj = fv_flat[cand[i]]                           # (K4, S, 3)
            mj = jnp.arange(S)[None, :] < nv_flat[cand[i]][:, None]
            b2 = jnp.stack(
                [jnp.sum(bj * u, -1), jnp.sum(bj * v, -1)], axis=-1
            )                                               # (K4, S, 2)

            def axes_of(p2, m):
                nxt = jnp.roll(p2, -1, axis=-2)
                e = nxt - p2
                return jnp.stack([-e[..., 1], e[..., 0]], -1), m

            axA, mA = axes_of(a2, mi)                       # (S, 2)
            axB, mB = axes_of(b2, mj)                       # (K4, S, 2)
            axes = jnp.concatenate(
                [jnp.broadcast_to(axA[None], (K4, S, 2)), axB], axis=1
            )                                               # (K4, 2S, 2)
            am = jnp.concatenate(
                [jnp.broadcast_to(mi[None], (K4, S)), mB], axis=1
            )
            pa = jnp.sum(a2[None, None] * axes[:, :, None, :], -1)  # (K4,2S,S)
            pb = jnp.sum(b2[:, None] * axes[:, :, None, :], -1)
            big = jnp.asarray(BIG, pa.dtype)
            a_lo = jnp.min(jnp.where(mi[None, None], pa, big), -1)
            a_hi = jnp.max(jnp.where(mi[None, None], pa, -big), -1)
            b_lo = jnp.min(jnp.where(mj[:, None], pb, big), -1)
            b_hi = jnp.max(jnp.where(mj[:, None], pb, -big), -1)
            sep = am & ((a_hi < b_lo - eps) | (b_hi < a_lo - eps))
            return ~jnp.any(sep, axis=-1)

        exact_ok = jax.vmap(pair_overlap)(jnp.arange(FPOOL)) & cmask
        # Face-pair → piece-level adjacency, scatter-free: piece adj via
        # per-face one-hot partner contraction over the K4 candidate slots.
        oh_j = jax.nn.one_hot(
            jnp.where(exact_ok, candp, P), P + 1, dtype=jnp.float32
        )[..., :P]                                          # (FPOOL, K4, P)
        contrib = jnp.max(oh_j, axis=1)                     # (FPOOL, P)
        adjf = jax.ops.segment_max(
            contrib, jnp.where(fok, owner[fsel], P),
            num_segments=P + 1,
        )[:P]                                               # (P, P)
        adj = adjf > 0.5
    else:
        # Face-level contact → piece-level adjacency: any own face in
        # contact with candidate slot k marks (owner, part[owner, k]).
        ok_piece = jnp.any(
            pair_ok.reshape(P, F, KP), axis=1
        )                                                    # (P, KP)
        oh = jax.nn.one_hot(
            jnp.where(ok_piece, part, P), P + 1, dtype=jnp.float32
        )[..., :P]                                           # (P, KP, P)
        adj = jnp.max(oh, axis=1) > 0.5
        split_overflow = jnp.int32(0)

    comp = adjacency_components(adj, pieces.valid)  # (P,) min reachable index

    # New group id: keep each component in its own compound; preserve the
    # original group id of the component's representative for stability.
    # Dense-renumber the incoming ids FIRST: post-fracture provisional ids
    # reach ~P·C, so (group·P + comp) would overflow int32 for large piece
    # pools; after renumbering the pairing is bounded by P² (safe to
    # P ≈ 46k).
    g = _dense_renumber(
        jnp.where(pieces.valid, pieces.group, -1), pieces.valid
    )
    new_group = jnp.where(
        pieces.valid,
        g * P + jnp.where(comp < P, comp, 0),
        -1,
    )
    # Dense renumber.
    new_group = _dense_renumber(new_group, pieces.valid)
    return (
        PieceSet(
            convex=pieces.convex,
            mesh=pieces.mesh,
            mesh_valid=pieces.mesh_valid,
            valid=pieces.valid,
            group=new_group,
            tag=pieces.tag,
        ),
        split_overflow,
    )


def _dense_renumber(group: jax.Array, valid: jax.Array) -> jax.Array:
    """Relabel group ids to a dense 0..G-1 range (order-preserving)."""
    P = group.shape[0]
    key = jnp.where(valid, group, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(key)
    sorted_key = key[order]
    first = (sorted_key != jnp.roll(sorted_key, 1)) | (jnp.arange(P) == 0)
    rank_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1
    rank = jnp.zeros((P,), jnp.int32).at[order].set(rank_sorted)
    return jnp.where(valid, rank, -1)
