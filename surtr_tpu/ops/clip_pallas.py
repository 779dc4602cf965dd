"""Batched plane fold: the clip behind every fracture cell and refit.

Semantics: identical to folding ``ops.clip.clip_poly_plane`` over a (K, 4)
plane list per polytope (the reference's plane loop in
Poly::ClipPolyhedron, reference Src/Poly.cpp:291-300).

On a GPU the fold is one Pallas kernel on the Triton route: one program per
polytope, whose (F, S) face loops stay in registers across all K plane
steps. The XLA version is a vmapped ``lax.scan`` that sends the polytope and
its compaction temporaries through device memory on every step. A plane
that removes no vertex costs the program one distance test.

Kernel-internal differences from ops.clip (same cyclic order, same results):
  * a plane cuts a convex face loop in at most two edges, so a face's new
    loop is its kept cyclic run followed by the exit and enter crossings (a
    rotation of the Sutherland–Hodgman stream);
  * cap points are ordered by the diamond pseudo-angle instead of atan2
    (identical cyclic order, no transcendentals);
  * when no vertex lies in the cutting plane the cap is exactly the faces'
    exit crossings; otherwise the candidates [enter, exit, first and last
    in-plane vertex] per face are pooled to 2·S slots before sorting and
    deduplication. Both paths truncate the cap loop to S vertices.
Lane shuffles are written as one-hot selections over the S axis, which
Triton keeps in registers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from surtr_tpu.device import target_is_gpu
from surtr_tpu.types import ConvexPoly

DEFAULT_TOL = 1e-6
BIG = 3.4e38
NUM_WARPS = 4   # warps per program (one polytope per program)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _angle_sort(qx, qy, qz, qm, u, v, OS):
    """Sort the masked (P,) candidates by angle about their centroid in the
    plane basis (u, v) into (OS,) slots; returns x, y, z and the count."""
    P = qx.shape[0]
    f32 = qx.dtype
    cnt = jnp.sum(qm.astype(jnp.int32))
    fcnt = jnp.maximum(cnt.astype(f32), 1.0)
    cx = jnp.sum(jnp.where(qm, qx, 0.0)) / fcnt
    cy = jnp.sum(jnp.where(qm, qy, 0.0)) / fcnt
    cz = jnp.sum(jnp.where(qm, qz, 0.0)) / fcnt
    rx, ry, rz = qx - cx, qy - cy, qz - cz
    pu = rx * u[0] + ry * u[1] + rz * u[2]
    pv = rx * v[0] + ry * v[1] + rz * v[2]
    # Diamond pseudo-angle: same cyclic order as atan2(pv, pu).
    den = jnp.maximum(jnp.abs(pu) + jnp.abs(pv), 1e-30)
    ang = jnp.where(pv >= 0, 1.0 - pu / den, 3.0 + pu / den)
    key = jnp.where(qm, ang, BIG)
    # Rank by (key, index) — unique, stable for equal keys.
    pi = jax.lax.broadcasted_iota(jnp.int32, (P, P), 0)
    pj = jax.lax.broadcasted_iota(jnp.int32, (P, P), 1)
    before = (key[:, None] < key[None, :]) | (
        (key[:, None] == key[None, :]) & (pi < pj)
    )
    rank = jnp.sum(before.astype(jnp.int32), axis=0)             # (P,)
    o = jax.lax.broadcasted_iota(jnp.int32, (OS, P), 0)
    sel = qm[None, :] & (rank[None, :] == o)                     # (OS, P)
    pick = lambda q: jnp.sum(jnp.where(sel, q[None, :], 0.0), axis=1)
    return pick(qx), pick(qy), pick(qz), jnp.minimum(cnt, OS)


def _fold_kernel(
    fvx_ref, fvy_ref, fvz_ref,           # (Fp, S) face loops
    nv_ref,                              # (Fp,) i32
    pnx_ref, pny_ref, pnz_ref, pd_ref,   # (Fp,) face planes
    cnx_ref, cny_ref, cnz_ref, cd_ref,   # (Kp,) clip planes
    cm_ref,                              # (Kp,) i32 plane mask
    ofvx_ref, ofvy_ref, ofvz_ref, onv_ref,
    opnx_ref, opny_ref, opnz_ref, opd_ref,
    *, F: int, K: int, tol: float,
):
    Fp, S = fvx_ref.shape
    slot = jax.lax.broadcasted_iota(jnp.int32, (Fp, S), 1)
    iota_f = jax.lax.broadcasted_iota(jnp.int32, (Fp,), 0)
    t3 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, S), 2)

    def take(a, idx):
        """a[f, idx[f, s]] as a one-hot selection over the S axis."""
        hit = idx[:, :, None] == t3
        return jnp.sum(jnp.where(hit, a[:, None, :], 0.0), axis=2)

    def update(plane, dist, st):
        fvx, fvy, fvz, nv, pnx, pny, pnz, pd = st
        nx, ny, nz, d = plane
        m = slot < nv[:, None]
        is_last = slot == nv[:, None] - 1
        nxt = jnp.where(is_last, 0, slot + 1)
        vnx, vny, vnz = take(fvx, nxt), take(fvy, nxt), take(fvz, nxt)
        dn = take(dist, nxt)

        kept = m & (dist <= tol)
        denom = dn - dist
        safe = jnp.where(jnp.abs(denom) > 1e-30, denom, 1.0)
        pcx = (fvx * dn - vnx * dist) / safe
        pcy = (fvy * dn - vny * dist) / safe
        pcz = (fvz * dn - vnz * dist) / safe

        # Cyclic-run emission: the kept vertices form one contiguous cyclic
        # run; the exit crossing (kept→removed edge) follows it and the
        # enter crossing (removed→kept edge) precedes it.
        cross_exit = m & (dist < -tol) & (dn > tol)
        cross_enter = m & (dist > tol) & (dn < -tol)
        row_sum = lambda c, q: jnp.sum(jnp.where(c, q, 0.0), axis=1)
        exit_x, exit_y, exit_z = (row_sum(cross_exit, q) for q in (pcx, pcy, pcz))
        enter_x, enter_y, enter_z = (
            row_sum(cross_enter, q) for q in (pcx, pcy, pcz)
        )
        ex_i = jnp.max(cross_exit.astype(jnp.int32), axis=1)       # (Fp,)
        en_i = jnp.max(cross_enter.astype(jnp.int32), axis=1)

        # Run start a = the kept vertex whose cyclic predecessor is removed
        # (0 when the face is intact).
        kept_i = kept.astype(jnp.int32)
        prv = jnp.where(slot == 0, nv[:, None] - 1, slot - 1)
        kprev = take(kept_i.astype(fvx.dtype), prv)
        startm = kept & (kprev < 0.5)
        a = jnp.sum(jnp.where(startm, slot, 0), axis=1)          # (Fp,)
        mcnt = jnp.sum(kept_i, axis=1)
        rot = jax.lax.rem(
            a[:, None] + slot,
            jnp.broadcast_to(jnp.maximum(nv, 1)[:, None], slot.shape),
        )
        in_run = slot < mcnt[:, None]
        at_exit = (slot == mcnt[:, None]) & (ex_i[:, None] > 0)
        at_enter = (slot == (mcnt + ex_i)[:, None]) & (en_i[:, None] > 0)

        def emit(q, ex, en):
            return jnp.where(
                in_run, take(q, rot),
                jnp.where(at_exit, ex[:, None],
                          jnp.where(at_enter, en[:, None], 0.0)),
            )

        out_x = emit(fvx, exit_x, enter_x)
        out_y = emit(fvy, exit_y, enter_y)
        out_z = emit(fvz, exit_z, enter_z)
        n_out = jnp.minimum(mcnt + ex_i + en_i, S)
        new_nv = jnp.where(n_out >= 3, n_out, 0)

        # In-plane basis (u, v) for angular ordering of the cap.
        nls = jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-30)
        ux_n, uy_n, uz_n = nx / nls, ny / nls, nz / nls
        ax_, ay_, az_ = jnp.abs(ux_n), jnp.abs(uy_n), jnp.abs(uz_n)
        # u = e × n for the axis e of n's smallest component.
        tx = (ax_ <= ay_) & (ax_ <= az_)
        ty = ~tx & (ay_ <= az_)
        zero = jnp.zeros_like(ux_n)
        ux = jnp.where(tx, zero, jnp.where(ty, uz_n, -uy_n))
        uy = jnp.where(tx, -uz_n, jnp.where(ty, zero, ux_n))
        uz = jnp.where(tx, uy_n, jnp.where(ty, -ux_n, zero))
        ul = jnp.maximum(jnp.sqrt(ux * ux + uy * uy + uz * uz), 1e-30)
        ux, uy, uz = ux / ul, uy / ul, uz / ul
        u = (ux, uy, uz)
        v = (uy_n * uz - uz_n * uy, uz_n * ux - ux_n * uz, ux_n * uy - uy_n * ux)

        removed = m & (dist > tol)
        touched = jnp.max(removed.astype(jnp.int32), axis=1) > 0
        inplane = m & (jnp.abs(dist) <= tol) & touched[:, None]
        ip_any = jnp.max(inplane.astype(jnp.int32)) > 0

        def cap_fast(_):
            # No in-plane vertex: every cap vertex is the exit crossing of
            # exactly one cut face (its twin is the neighbor's enter — the
            # same bits), so the exit set IS the cap.
            return _angle_sort(exit_x, exit_y, exit_z, ex_i > 0, u, v, S)

        def cap_slow(_):
            # A vertex on the plane: pool [enter, exit, first in-plane, last
            # in-plane] per face into 2·S slots, sort, deduplicate, compact.
            fslot = jnp.min(jnp.where(inplane, slot, S), axis=1)
            lslot = jnp.max(jnp.where(inplane, slot, -1), axis=1)
            fsel = inplane & (slot == fslot[:, None])
            lsel = inplane & (slot == lslot[:, None])
            c4 = jax.lax.broadcasted_iota(jnp.int32, (1, 4), 1)

            def cands(en, exv, q):
                return jnp.where(
                    c4 == 0, en[:, None],
                    jnp.where(c4 == 1, exv[:, None],
                              jnp.where(c4 == 2, row_sum(fsel, q)[:, None],
                                        row_sum(lsel, q)[:, None])),
                )                                                 # (Fp, 4)

            px = cands(enter_x, exit_x, fvx)
            py = cands(enter_y, exit_y, fvy)
            pz = cands(enter_z, exit_z, fvz)
            pm = jnp.where(
                c4 == 0, en_i[:, None] > 0,
                jnp.where(c4 == 1, ex_i[:, None] > 0,
                          jnp.where(c4 == 2, (fslot < S)[:, None],
                                    (lslot > fslot)[:, None])),
            )
            pm_i = pm.astype(jnp.int32)
            rowcnt = jnp.sum(pm_i, axis=1)
            pos = (jnp.cumsum(rowcnt) - rowcnt)[:, None] + jnp.cumsum(pm_i, axis=1)
            P2 = 2 * S
            o3 = jax.lax.broadcasted_iota(jnp.int32, (P2, 1, 1), 0)
            sel3 = pm[None] & (pos[None] == o3 + 1)              # (2S, Fp, 4)
            pool = lambda q: jnp.sum(
                jnp.sum(jnp.where(sel3, q[None], 0.0), axis=2), axis=1
            )
            cnt = jnp.minimum(jnp.sum(rowcnt), P2)
            gm = jax.lax.broadcasted_iota(jnp.int32, (P2,), 0) < cnt
            sx, sy, sz, scnt = _angle_sort(pool(px), pool(py), pool(pz), gm,
                                           u, v, P2)
            # Duplicates (the shared crossing of two faces, vertex copies)
            # sort adjacently: drop each entry equal to its predecessor.
            o2 = jax.lax.broadcasted_iota(jnp.int32, (P2, P2), 0)
            j2 = jax.lax.broadcasted_iota(jnp.int32, (P2, P2), 1)
            prev_of = j2 == o2 - 1
            prev = lambda q: jnp.sum(jnp.where(prev_of, q[None, :], 0.0), axis=1)
            first = jax.lax.broadcasted_iota(jnp.int32, (P2,), 0) == 0
            dup = ~first & (sx == prev(sx)) & (sy == prev(sy)) & (sz == prev(sz))
            keep = (jax.lax.broadcasted_iota(jnp.int32, (P2,), 0) < scnt) & ~dup
            kpos = jnp.cumsum(keep.astype(jnp.int32))
            oS = jax.lax.broadcasted_iota(jnp.int32, (S, P2), 0)
            selc = keep[None, :] & (kpos[None, :] == oS + 1)     # (S, 2S)
            pick = lambda q: jnp.sum(jnp.where(selc, q[None, :], 0.0), axis=1)
            n_cap = jnp.minimum(jnp.sum(keep.astype(jnp.int32)), S)
            return pick(sx), pick(sy), pick(sz), n_cap

        capx, capy, capz, n_cap = jax.lax.cond(ip_any, cap_slow, cap_fast, 0)

        # Cap into the first free face slot below F (masked select).
        free = (new_nv == 0) & (iota_f < F)
        first_free = jnp.min(jnp.where(free, iota_f, Fp))
        put = (iota_f == first_free) & (n_cap >= 3)
        put2 = put[:, None]
        nv2 = jnp.where(put, n_cap, new_nv)
        # Degenerate wipe: fewer than 4 live faces clears the polytope.
        alive = jnp.sum((nv2 >= 3).astype(jnp.int32)) >= 4
        return (
            jnp.where(put2, capx[None, :], out_x),
            jnp.where(put2, capy[None, :], out_y),
            jnp.where(put2, capz[None, :], out_z),
            jnp.where(alive, nv2, 0),
            jnp.where(put, nx, pnx),
            jnp.where(put, ny, pny),
            jnp.where(put, nz, pnz),
            jnp.where(put, d, pd),
        )

    def body(k, st):
        ok = cm_ref[k] > 0
        # A masked-out plane is the all-kept no-op plane (0, 0, 0, -1).
        plane = (
            jnp.where(ok, cnx_ref[k], 0.0),
            jnp.where(ok, cny_ref[k], 0.0),
            jnp.where(ok, cnz_ref[k], 0.0),
            jnp.where(ok, cd_ref[k], -1.0),
        )
        fvx, fvy, fvz, nv = st[:4]
        dist = fvx * plane[0] + fvy * plane[1] + fvz * plane[2] + plane[3]
        removed = (slot < nv[:, None]) & (dist > tol)
        cut = jnp.max(removed.astype(jnp.int32)) > 0
        return jax.lax.cond(
            cut, lambda s: update(plane, dist, s), lambda s: s, st
        )

    st = (
        fvx_ref[...], fvy_ref[...], fvz_ref[...], nv_ref[...],
        pnx_ref[...], pny_ref[...], pnz_ref[...], pd_ref[...],
    )
    st = jax.lax.fori_loop(0, K, body, st)
    for ref, val in zip(
        (ofvx_ref, ofvy_ref, ofvz_ref, onv_ref,
         opnx_ref, opny_ref, opnz_ref, opd_ref),
        st,
    ):
        ref[...] = val


@functools.partial(jax.jit, static_argnames=("tol", "interpret"))
def clip_planes_batch_pallas(
    poly: ConvexPoly,
    planes: jax.Array,
    plane_mask: jax.Array,
    tol: float = DEFAULT_TOL,
    interpret: bool = False,
) -> ConvexPoly:
    """Batched K-plane fold on the GPU: poly batch (N, F, S), planes
    (N, K, 4), plane_mask (N, K). S must be a power of two; F and K are
    padded to powers of two inside."""
    N, F, S = poly.face_verts.shape[0], poly.F, poly.S
    K = planes.shape[1]
    if S != _pow2(S):
        raise ValueError(f"face-loop slots S={S} must be a power of two")
    Fp, Kp = _pow2(F), _pow2(max(K, 1))
    dtype = poly.face_verts.dtype
    padF = lambda a: jnp.pad(a, [(0, 0), (0, Fp - F)] + [(0, 0)] * (a.ndim - 2))
    padK = lambda a: jnp.pad(a, ((0, 0), (0, Kp - K)))
    fv = padF(poly.face_verts)
    pp = padF(poly.planes)
    ins = (
        fv[..., 0], fv[..., 1], fv[..., 2], padF(poly.n_verts),
        pp[..., 0], pp[..., 1], pp[..., 2], pp[..., 3],
        padK(planes[..., 0]), padK(planes[..., 1]), padK(planes[..., 2]),
        padK(planes[..., 3]), padK(plane_mask.astype(jnp.int32)),
    )
    loop = pl.BlockSpec((None, Fp, S), lambda i: (i, 0, 0))
    face = pl.BlockSpec((None, Fp), lambda i: (i, 0))
    clip = pl.BlockSpec((None, Kp), lambda i: (i, 0))
    outs = pl.pallas_call(
        functools.partial(_fold_kernel, F=F, K=K, tol=tol),
        grid=(N,),
        in_specs=[loop] * 3 + [face] * 5 + [clip] * 5,
        out_specs=tuple([loop] * 3 + [face] * 5),
        out_shape=tuple(
            [jax.ShapeDtypeStruct((N, Fp, S), dtype)] * 3
            + [jax.ShapeDtypeStruct((N, Fp), jnp.int32)]
            + [jax.ShapeDtypeStruct((N, Fp), dtype)] * 4
        ),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="plane_fold",
    )(*ins)
    fvx, fvy, fvz, nv, pnx, pny, pnz, pd = (o[:, :F] for o in outs)
    return ConvexPoly(
        jnp.stack([fvx, fvy, fvz], axis=-1),
        nv,
        jnp.stack([pnx, pny, pnz, pd], axis=-1),
    )


def clip_planes_batch(
    poly: ConvexPoly,
    planes: jax.Array,
    plane_mask: jax.Array | None = None,
    tol: float = DEFAULT_TOL,
) -> ConvexPoly:
    """Batched K-plane fold: poly batch (N, F, S), planes (N, K, 4).

    GPU (and S a power of two) → the kernel above; otherwise the XLA scan
    fold (``ops.clip.clip_poly_planes`` under vmap).
    """
    from surtr_tpu.ops.clip import clip_poly_planes

    N, K = planes.shape[0], planes.shape[1]
    if plane_mask is None:
        plane_mask = jnp.ones((N, K), bool)
    if target_is_gpu() and poly.S == _pow2(poly.S) and N > 0 and K > 0:
        return clip_planes_batch_pallas(poly, planes, plane_mask, tol=tol)
    return jax.vmap(
        lambda p, pls, pm: clip_poly_planes(p, pls, pm, tol)
    )(poly, planes, plane_mask)
