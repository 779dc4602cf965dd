"""The jitted rigid-body step — the replacement for PhysX's
``simulate(1/120)/fetchResults`` (/root/reference/Src/Surtr.cpp:330-331).

One call = one fixed 1/120 s step, entirely on device:
  1. world hull transforms (broadcast rotations) + per-piece 26-DOP
     support intervals,
  2. broadphase, full recall by default (the PhysX no-missed-pairs
     contract): "auto" is the exact blocked all-pairs sweep at every size.
     The Morton-window sweep ("sorted", which misses 20-30% of the exact
     top-K pairs on dense piles) and the bucket-capped grid run only when
     asked for by name. Symmetrized to mutual lists.
  3. narrowphase SAT over {26-DOP axes, faces of both hulls (via plane
     distances), edge×edge cross axes} + a containment manifold: up to M
     contact points per pair = each hull's vertices inside the other hull,
     deepest first, with a single support-point fallback (the PhysX-style
     multi-point manifold PARITY.md flagged as missing in round 1).
  4. Jacobi projected-impulse solver with mass splitting, Baumgarte bias,
     Coulomb friction μ=0.5, restitution 0.1 (PxMaterial parity,
     Surtr.cpp:1160). Each side of a mutual pair computes the same impulse
     and applies only its own half — reshape-sums and plain gathers, no
     scatter anywhere. With
     cfg.single_piece_bodies the per-body reduction is the identity and the
     solver runs gather-free on the own-body side.
  5. symplectic Euler integration with quaternion renormalization.

Piece→body reduction uses the sorted-owner segmented-cumsum trick: build_scene
sorts pieces by owner, so a body's sum is a difference of two cumsum reads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from surtr_tpu.config import PhysicsConfig
from surtr_tpu.ops.kdop import dop26_directions
from surtr_tpu.ops.linalg import matvec3, rot_points
from surtr_tpu.physics.rigid import quat_integrate, quat_to_mat, world_inv_inertia
from surtr_tpu.physics.scene import PhysicsScene, piece_world_verts

BIG = 3.4e38


# ---------------------------------------------------------------------------
# broadphase
# ---------------------------------------------------------------------------


def _broadphase(centers, lo, hi, owner, valid, K, block):
    """Exact blocked O(N²) sweep: top-K nearest overlapping candidates."""
    Np = centers.shape[0]
    nblk = (Np + block - 1) // block
    pad = nblk * block - Np
    rows = jnp.arange(block)
    cpad = jnp.pad(centers, ((0, pad), (0, 0)))
    lopad = jnp.pad(lo, ((0, pad), (0, 0)))
    hipad = jnp.pad(hi, ((0, pad), (0, 0)))
    ownpad = jnp.pad(owner, (0, pad), constant_values=-2)
    valpad = jnp.pad(valid, (0, pad))

    def one_block(b):
        r0 = b * block
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, r0, block)
        c, lo_r, hi_r = sl(cpad), sl(lopad), sl(hipad)
        own_r, val_r = sl(ownpad), sl(valpad)
        gidx = r0 + rows
        overlap = jnp.all(
            (lo_r[:, None] <= hi[None]) & (lo[None] <= hi_r[:, None]), axis=-1
        )
        ok = (
            overlap
            & (own_r[:, None] != owner[None, :])
            & val_r[:, None]
            & valid[None, :]
            & (gidx[:, None] != jnp.arange(Np)[None, :])
        )
        d2 = jnp.sum((c[:, None] - centers[None]) ** 2, axis=-1)
        score = jnp.where(ok, -d2, -BIG)
        kk = min(K, Np)
        neg, idx = jax.lax.top_k(score, kk)
        if kk < K:
            neg = jnp.pad(neg, ((0, 0), (0, K - kk)), constant_values=-BIG)
            idx = jnp.pad(idx, ((0, 0), (0, K - kk)))
        return idx, neg > -BIG / 2

    idx, ok = jax.lax.map(one_block, jnp.arange(nblk))
    return idx.reshape(-1, K)[:Np], ok.reshape(-1, K)[:Np]


def _broadphase_grid(centers, lo, hi, owner, valid, K, cap):
    """Uniform-grid broadphase: FULL recall up to ``cap`` members per cell.

    Cell size = the largest piece AABB extent, so any overlapping pair's
    centers land within one cell of each other per axis — each piece needs
    only its 27 neighbor cells. Pieces sort once by packed cell key
    (10 bits/axis); each neighbor cell's members are a CONTIGUOUS run of
    the sorted table found by ``searchsorted``, so candidate assembly is
    one (Np, 27·cap) row gather. Candidates get the exact AABB test, and
    the K nearest survive.

    Unlike the Morton-window sweep (whose misses depend on space-filling-
    curve locality and are unbounded), this path misses a pair ONLY when a
    probed three-cell column holds more than ``3·cap`` pieces — the same
    observable-cap policy as the K-neighbor limit itself.

    The (Np, 27·cap) candidate row gather and the batched searchsorted
    dominate its cost.
    """
    Np = centers.shape[0]
    f = centers.dtype
    big = jnp.asarray(BIG, f)
    ext = jnp.max(jnp.where(valid[:, None], hi - lo, 0.0))
    h = jnp.maximum(ext, 1e-6) * (1.0 + 1e-5)
    wlo = jnp.min(jnp.where(valid[:, None], centers, big), axis=0)
    # +1 so the -1 neighbor offset cannot underflow a field; clipping far
    # pieces into the boundary cell adds candidates (and counted overflow),
    # never misses.
    cc = jnp.clip(
        jnp.floor((centers - wlo) / h).astype(jnp.int32) + 1, 1, 1022
    )
    key = (cc[:, 0] << 20) | (cc[:, 1] << 10) | cc[:, 2]
    key = jnp.where(valid, key, jnp.int32(0x7F000000))

    order = jnp.argsort(key)
    keys_s = key[order]
    pack = jnp.concatenate(
        [centers, lo, hi, owner[:, None].astype(f),
         valid[:, None].astype(f)],
        axis=1,
    )[order]                                        # (Np, 11) one gather
    orig_s = order.astype(jnp.int32)

    # z is the LOW key field, so a (dx, dy) neighbor COLUMN's three cells
    # z-1..z+1 are one contiguous run [key(dx,dy,-1), key(dx,dy,+1)] of the
    # sorted table — 9 column probes instead of 27 cell probes. Arithmetic
    # (not bitwise-OR) combination: negative offsets must borrow across
    # the packed fields. One batched sort-method lookup for every [start,
    # end) (the scan method is a sequential loop, ~4× slower here, and a
    # per-candidate key gather to test membership costs more than the
    # whole candidate-row gather).
    dcols = [
        dx * (1 << 20) + dy * (1 << 10)
        for dx in (-1, 0, 1) for dy in (-1, 0, 1)
    ]
    dc = jnp.asarray(dcols, jnp.int32)[None, :]
    se = jnp.searchsorted(
        keys_s,
        jnp.concatenate(
            [keys_s[:, None] + (dc - 1), keys_s[:, None] + (dc + 2)], axis=1
        ).ravel(),
        method="sort",
    ).reshape(Np, 18)
    start, end = se[:, :9], se[:, 9:]
    ccap = 3 * cap
    ranks = (
        start[:, :, None] + jnp.arange(ccap, dtype=jnp.int32)[None, None]
    ).reshape(Np, 9 * ccap)
    rk = jnp.clip(ranks, 0, Np - 1)
    in_cell = ranks < jnp.repeat(end, ccap, axis=1)

    cand = pack[rk]                                 # (Np, 27·cap, 11)
    cj, loj, hij = cand[..., 0:3], cand[..., 3:6], cand[..., 6:9]
    ownj = cand[..., 9].astype(jnp.int32)
    valj = cand[..., 10] > 0.5
    c_s, lo_s, hi_s = pack[:, 0:3], pack[:, 3:6], pack[:, 6:9]
    own_s = pack[:, 9].astype(jnp.int32)
    val_s = pack[:, 10] > 0.5
    overlap = jnp.all((lo_s[:, None] <= hij) & (loj <= hi_s[:, None]), -1)
    ok = (
        overlap & in_cell & valj & val_s[:, None]
        & (ownj != own_s[:, None]) & (rk != jnp.arange(Np)[:, None])
    )
    d2 = jnp.sum((c_s[:, None] - cj) ** 2, axis=-1)
    score = jnp.where(ok, -d2, -BIG)
    neg, kidx = jax.lax.top_k(score, K)             # (Np, K) into 27·cap
    part_rank = jnp.take_along_axis(rk, kidx, axis=1)
    pok_s = neg > -BIG / 2
    inv = jnp.argsort(order)
    pidx = orig_s[part_rank][inv]
    return pidx, pok_s[inv]


def _morton(centers, valid):
    """30-bit Morton code of quantized centers; invalid rows sort last."""
    big = jnp.asarray(BIG, centers.dtype)
    lo = jnp.min(jnp.where(valid[:, None], centers, big), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], centers, -big), axis=0)
    # UNIFORM scale across axes: per-axis normalization makes tiny jitters
    # along a thin axis dominate the interleaved bits and destroys Morton
    # locality on anisotropic scenes (a flat 10k pile measured 63% missed
    # pairs per-axis vs 22% uniform at window=32).
    ext = jnp.maximum(jnp.max(hi - lo), 1e-6)
    q = jnp.clip(
        ((centers - lo) / ext * 1023.0).astype(jnp.int32), 0, 1023
    )  # (Np, 3)

    def spread(x):
        # 10 bits → every 3rd bit (classic bit-spread).
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return jnp.where(valid, code, jnp.int32(0x7FFFFFFF))


def _broadphase_sorted(centers, lo, hi, owner, valid, K, window):
    """Morton-window broadphase: sort by Morton code, test the ±window
    sorted neighbors exactly (AABB overlap), keep the K nearest.

    O(Np·window) instead of the blocked O(Np²) sweep, and the candidate
    tables are ROLLS of the sorted table. The window bounds
    locality: spatial neighbors landing > window apart in Morton order are
    missed — the same capacity approximation as the K-neighbor cap itself.
    """
    Np = centers.shape[0]
    code = _morton(centers, valid)
    order = jnp.argsort(code)                       # (Np,) sorted → original
    inv = jnp.argsort(order)                        # original → rank

    pack = jnp.concatenate(
        [centers, lo, hi, owner[:, None].astype(centers.dtype),
         valid[:, None].astype(centers.dtype)],
        axis=1,
    )[order]                                        # (Np, 11) one gather

    deltas = list(range(1, window + 1)) + [-d for d in range(1, window + 1)]
    cand = jnp.stack(
        [jnp.roll(pack, -d, axis=0) for d in deltas], axis=1
    )                                               # (Np, 2W, 11)
    r = jnp.arange(Np, dtype=jnp.int32)
    didx = jnp.asarray(deltas, jnp.int32)
    rank_j = r[:, None] + didx[None, :]
    in_rng = (rank_j >= 0) & (rank_j < Np)

    c_s, lo_s, hi_s = pack[:, 0:3], pack[:, 3:6], pack[:, 6:9]
    own_s = pack[:, 9].astype(jnp.int32)
    val_s = pack[:, 10] > 0.5
    cj, loj, hij = cand[..., 0:3], cand[..., 3:6], cand[..., 6:9]
    ownj = cand[..., 9].astype(jnp.int32)
    valj = cand[..., 10] > 0.5

    overlap = jnp.all((lo_s[:, None] <= hij) & (loj <= hi_s[:, None]), -1)
    ok = (
        overlap & in_rng & valj & val_s[:, None] & (ownj != own_s[:, None])
    )
    d2 = jnp.sum((c_s[:, None] - cj) ** 2, axis=-1)
    score = jnp.where(ok, -d2, -BIG)
    kk = min(K, len(deltas))
    neg, kidx = jax.lax.top_k(score, kk)             # (Np, kk) into 2W
    if kk < K:
        neg = jnp.pad(neg, ((0, 0), (0, K - kk)), constant_values=-BIG)
        kidx = jnp.pad(kidx, ((0, 0), (0, K - kk)))
    part_rank = jnp.clip(
        r[:, None] + didx[kidx], 0, Np - 1
    )                                                # (Np, K) sorted idx
    part_orig = order[part_rank]                     # (Np, K) original idx
    pok_s = neg > -BIG / 2
    # Back to original piece order.
    return part_orig[inv], pok_s[inv]


def _broadphase_select(centers, lo, hi, owner, valid, cfg: PhysicsConfig):
    """The configured broadphase, reduced to mutual (Np, K) pair lists.

    "auto" is the exact blocked sweep: full recall at every size (the PhysX
    contract is "no missed pairs"). The Morton-window sweep, which misses
    pairs on dense piles, and the bucket-capped grid run only when asked
    for by name."""
    K = cfg.max_neighbors
    if cfg.broadphase == "auto":
        pidx, pok = _broadphase(
            centers, lo, hi, owner, valid, K, cfg.broadphase_block
        )
    elif cfg.broadphase == "sorted":
        pidx, pok = _broadphase_sorted(
            centers, lo, hi, owner, valid, K, cfg.broadphase_window
        )
    elif cfg.broadphase == "grid":
        pidx, pok = _broadphase_grid(
            centers, lo, hi, owner, valid, K, cfg.broadphase_bucket_cap
        )
    else:
        raise ValueError(f"unknown broadphase mode {cfg.broadphase!r}")
    partner_lists = pidx[pidx]                     # (Np, K, K)
    me = jnp.arange(pidx.shape[0], dtype=jnp.int32)[:, None, None]
    return pidx, pok & jnp.any(partner_lists == me, axis=-1)


def _world_aabbs(scene: PhysicsScene, margin):
    """Stage 1 bounds: world hull verts and the slop-padded piece AABBs.

    Returns (wverts, wmask, lo, hi, centers); invalid pieces get centers at
    +BIG so no sweep pairs them."""
    pvalid = scene.piece_valid & (scene.piece_owner >= 0)
    big = jnp.asarray(BIG, scene.piece_verts.dtype)
    wverts, wmask = piece_world_verts(scene)               # (Np, Vh, 3)
    lo = jnp.min(jnp.where(wmask[..., None], wverts, big), axis=1) - margin
    hi = jnp.max(jnp.where(wmask[..., None], wverts, -big), axis=1) + margin
    centers = jnp.where(pvalid[:, None], (lo + hi) * 0.5, big)
    return wverts, wmask, lo, hi, centers


@functools.partial(jax.jit, static_argnames=("cfg",))
def broadphase_pairs(scene: PhysicsScene, cfg: PhysicsConfig):
    """The mutual (Np, K) candidate pairs the next ``physics_step`` uses:
    (partner piece index, live mask)."""
    _, _, lo, hi, centers = _world_aabbs(scene, cfg.contact_slop * 4.0)
    pvalid = scene.piece_valid & (scene.piece_owner >= 0)
    return _broadphase_select(
        centers, lo, hi, scene.piece_owner, pvalid, cfg
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _stage_out(scene: PhysicsScene, *arrays) -> PhysicsScene:
    """Profiling early-exit: fold a reduction of the stage outputs into
    bodies.x so the truncated program keeps the stage's compute live."""
    import dataclasses

    s = jnp.float32(0)
    for a in arrays:
        s = s + jnp.sum(a.astype(jnp.float32))
    bodies = scene.bodies
    new_bodies = type(bodies)(
        x=bodies.x + s.astype(bodies.x.dtype) * 1e-30,
        q=bodies.q, v=bodies.v, w=bodies.w,
        inv_mass=bodies.inv_mass,
        inv_inertia_body=bodies.inv_inertia_body,
        active=bodies.active,
    )
    return dataclasses.replace(scene, bodies=new_bodies)


def _ground_contacts(cfg, wverts, wmask, pvalid):
    """Stage 3c: deepest G verts below y = ground_y. Returns
    g_pts (Np, G, 3), gd (Np, G), g_hit (Np, G)."""
    G = cfg.max_ground_contacts
    depth_v = cfg.ground_y - wverts[..., 1]
    below = wmask & (depth_v > -cfg.contact_slop)
    gd, gidx = jax.lax.top_k(jnp.where(below, depth_v, -BIG), G)
    g_hit = (gd > -cfg.contact_slop) & pvalid[:, None]
    g_pts = jnp.take_along_axis(wverts, gidx[..., None], axis=1)
    return g_pts, gd, g_hit


def _segment_sums(piece_vals: jax.Array, seg_start: jax.Array):
    """Per-body sums of piece values when pieces are sorted by owner.

    piece_vals: (Np, D); seg_start: (B+1,) start offsets. Returns (B, D).
    Pure cumsum + two gathers — no scatter."""
    csum = jnp.concatenate(
        [jnp.zeros_like(piece_vals[:1]), jnp.cumsum(piece_vals, axis=0)]
    )
    return csum[seg_start[1:]] - csum[seg_start[:-1]]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "profile_stage"))
def physics_step(
    scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int = 99
) -> PhysicsScene:
    """One fixed step. ``profile_stage`` truncates the step after stage N
    (1=transforms, 2=broadphase, 3=narrowphase, 4=solver) for per-phase device
    timing (SURVEY §5 tracing) — production callers leave the default."""
    if (
        cfg.sleep_velocity > 0
        and cfg.skip_all_asleep
        and profile_stage >= 99
    ):
        # Fully settled scene: one predicate instead of a full step (the
        # PhysX analogue — a sleeping island costs nothing). Nothing inside
        # physics_step can wake a scene whose every active body is asleep
        # (wakes need a moving contact), so the identity branch is exact.
        bodies0 = scene.bodies
        all_asleep = jnp.all(
            (scene.sleep_frames >= cfg.sleep_frames) | ~bodies0.active
        ) & jnp.any(bodies0.active)
        return jax.lax.cond(
            all_asleep,
            lambda s: s,
            lambda s: _physics_step_body(s, cfg, profile_stage),
            scene,
        )
    return _physics_step_body(scene, cfg, profile_stage)


def _physics_step_body(
    scene: PhysicsScene, cfg: PhysicsConfig, profile_stage: int = 99
) -> PhysicsScene:
    bodies = scene.bodies
    Np, B = scene.Np, scene.B
    K = cfg.max_neighbors
    G = cfg.max_ground_contacts
    M = max(1, cfg.manifold_points)
    Ne = cfg.max_edge_dirs
    C = K * M + G
    # The gather-free fast path needs row i ↔ body i, which holds exactly
    # when every body owns one piece and the pools are the same size.
    single = cfg.single_piece_bodies and scene.Np == scene.B

    nEd = max(Ne, 0)
    owner = jnp.clip(scene.piece_owner, 0, B - 1)
    pvalid = scene.piece_valid & (scene.piece_owner >= 0)
    Vh = scene.piece_verts.shape[1]
    Fp = scene.piece_planes.shape[1]
    margin = cfg.contact_slop * 4.0
    big = jnp.asarray(BIG, scene.piece_verts.dtype)
    # --- 1. world transforms + 26-DOP support intervals.
    wverts, wmask, lo, hi, centers = _world_aabbs(scene, margin)

    Rw = quat_to_mat(bodies.q)[owner]
    x_own = bodies.x[owner]
    wplanes_n = rot_points(Rw, scene.piece_planes[..., :3])  # (Np, F, 3)
    wplanes_d = scene.piece_planes[..., 3] - jnp.sum(
        wplanes_n * x_own[:, None, :], axis=-1
    )                                                      # (Np, F)
    wedges = rot_points(Rw, scene.piece_edges)             # (Np, Ne, 3)

    base = dop26_directions(wverts.dtype)                  # (13, 3)
    t_dop = jnp.sum(
        wverts[:, :, None, :] * base[None, None], axis=-1
    )                                                      # (Np, Vh, 13)
    mdop = wmask[..., None]
    lo_dop = jnp.min(jnp.where(mdop, t_dop, big), axis=1)  # (Np, 13)
    hi_dop = jnp.max(jnp.where(mdop, t_dop, -big), axis=1)


    if profile_stage <= 1:
        return _stage_out(scene, centers, lo_dop, hi_dop)

    # --- 2. broadphase, symmetrized (contact only when both sides list it).
    pidx, pok = _broadphase_select(
        centers, lo, hi, scene.piece_owner, pvalid, cfg
    )

    if profile_stage <= 2:
        return _stage_out(scene, pidx, pok)

    # --- 3a. pair narrowphase (SAT), piece-major pair slots (Np, K).
    # Gather-count discipline: ONE packed gather brings every per-partner
    # table; the i-side needs no gather (broadcast along K).
    parts = [
        wverts.reshape(Np, Vh * 3),
        wmask.astype(wverts.dtype),
        wplanes_n.reshape(Np, Fp * 3),
        wplanes_d,
        scene.piece_pmask.astype(wverts.dtype),
        lo_dop, hi_dop,
    ]
    if nEd:
        parts += [
            wedges.reshape(Np, nEd * 3),
            scene.piece_emask.astype(wverts.dtype),
        ]
    packed = jnp.concatenate(parts, axis=1)                    # (Np, D)
    pj = packed[pidx]                                          # (Np, K, D)
    o = 0
    jverts = pj[..., o : o + Vh * 3].reshape(Np, K, Vh, 3); o += Vh * 3
    jmask = pj[..., o : o + Vh] > 0.5; o += Vh
    jplanes_n = pj[..., o : o + Fp * 3].reshape(Np, K, Fp, 3); o += Fp * 3
    jplanes_d = pj[..., o : o + Fp]; o += Fp
    jpmask = pj[..., o : o + Fp] > 0.5; o += Fp
    jlo_dop = pj[..., o : o + 13]; o += 13
    jhi_dop = pj[..., o : o + 13]; o += 13
    if nEd:
        jedges = pj[..., o : o + nEd * 3].reshape(Np, K, nEd, 3); o += nEd * 3
        jemask = pj[..., o : o + nEd] > 0.5

    pens, axdirs, axmask = [], [], []

    # (1) 26-DOP axes: precomputed per-piece intervals → pure interval math.
    ov_dop = jnp.minimum(hi_dop[:, None], jhi_dop) - jnp.maximum(
        lo_dop[:, None], jlo_dop
    )                                                          # (Np, K, 13)
    mid_flip = (hi_dop + lo_dop)[:, None] < (jhi_dop + jlo_dop)
    dir_dop = jnp.where(
        mid_flip[..., None], -base[None, None], base[None, None]
    )
    pens.append(ov_dop)
    axdirs.append(jnp.broadcast_to(dir_dop, (Np, K, 13, 3)))
    axmask.append(jnp.ones((Np, K, 13), bool))

    # (2) i-verts against j's face planes: penetration = -min signed dist.
    # Face support of the owning hull is 0 by construction, so the interval
    # overlap along a face axis IS the negated minimum vertex distance.
    dist_ij = (
        jnp.sum(wverts[:, None, :, None, :] * jplanes_n[:, :, None], -1)
        + jplanes_d[:, :, None, :]
    )                                                          # (Np,K,Vh,F)
    mi4 = wmask[:, None, :, None]
    pen_fj = -jnp.min(jnp.where(mi4, dist_ij, big), axis=2)    # (Np,K,F)
    pens.append(pen_fj)
    axdirs.append(jplanes_n)                                   # n_j points j→i
    axmask.append(jpmask)

    # (3) j-verts against i's face planes.
    dist_ji = (
        jnp.sum(jverts[:, :, :, None, :] * wplanes_n[:, None, None], -1)
        + wplanes_d[:, None, None, :]
    )                                                          # (Np,K,Vh,F)
    mj4 = jmask[..., None]
    pen_fi = -jnp.min(jnp.where(mj4, dist_ji, big), axis=2)
    pens.append(pen_fi)
    axdirs.append(jnp.broadcast_to(-wplanes_n[:, None], (Np, K, Fp, 3)))
    axmask.append(jnp.broadcast_to(scene.piece_pmask[:, None], (Np, K, Fp)))

    # (4) edge×edge cross axes.
    if nEd:
        E2 = nEd * nEd
        ex = jnp.cross(
            wedges[:, None, :, None, :], jedges[:, :, None, :, :]
        ).reshape(Np, K, E2, 3)
        exn = jnp.linalg.norm(ex, axis=-1)
        ex = ex / jnp.maximum(exn, 1e-30)[..., None]
        emask2 = (
            (scene.piece_emask[:, None, :, None] & jemask[:, :, None, :])
            .reshape(Np, K, E2)
            & (exn > 1e-6)
        )
        ti = jnp.sum(
            wverts[:, None, :, None, :] * ex[:, :, None], -1
        )                                                      # (Np,K,Vh,E2)
        tj = jnp.sum(jverts[..., None, :] * ex[:, :, None], -1)
        ilo = jnp.min(jnp.where(mi4, ti, big), 2)
        ihi = jnp.max(jnp.where(mi4, ti, -big), 2)
        jlo = jnp.min(jnp.where(mj4, tj, big), 2)
        jhi = jnp.max(jnp.where(mj4, tj, -big), 2)
        ov_e = jnp.minimum(ihi, jhi) - jnp.maximum(ilo, jlo)
        flip_e = (ihi + ilo) < (jhi + jlo)
        dir_e = jnp.where(flip_e[..., None], -ex, ex)
        pens.append(ov_e)
        axdirs.append(dir_e)
        axmask.append(emask2)

    pen_all = jnp.concatenate(pens, axis=2)                    # (Np,K,D)
    dir_all = jnp.concatenate(axdirs, axis=2)                  # (Np,K,D,3)
    msk_all = jnp.concatenate(axmask, axis=2)
    pen_all = jnp.where(msk_all, pen_all, BIG)
    a = jnp.argmin(pen_all, axis=-1)
    depth = jnp.take_along_axis(pen_all, a[..., None], axis=-1)[..., 0]
    pc_n = jnp.take_along_axis(
        dir_all, a[..., None, None], axis=2
    )[..., 0, :]                                               # (Np,K,3) j→i
    pair_hit = pok & (depth > -cfg.contact_slop) & (depth < BIG / 2)

    # --- 3b. containment manifold: each hull's verts inside the other.
    slop = cfg.contact_slop
    si_n = jnp.sum(wverts[:, None] * pc_n[:, :, None, :], -1)  # (Np,K,Vh)
    sj_n = jnp.sum(jverts * pc_n[:, :, None, :], -1)
    si_min = jnp.min(jnp.where(wmask[:, None], si_n, big), -1)  # (Np,K)
    sj_max = jnp.max(jnp.where(jmask, sj_n, -big), -1)
    inside_j = (
        jnp.max(jnp.where(jpmask[:, :, None, :], dist_ij, -big), -1) <= slop
    )                                                          # (Np,K,Vh)
    inside_i = (
        jnp.max(
            jnp.where(scene.piece_pmask[:, None, None, :], dist_ji, -big), -1
        )
        <= slop
    )
    depth_iv = sj_max[..., None] - si_n                        # (Np,K,Vh)
    depth_jv = sj_n - si_min[..., None]
    score_i = jnp.where(inside_j & wmask[:, None], depth_iv, -BIG)
    score_j = jnp.where(inside_i & jmask, depth_jv, -BIG)
    scores = jnp.concatenate([score_i, score_j], axis=-1)      # (Np,K,2Vh)
    # M sequential one-hot max extractions: top_k over 2Vh lowers to a sort
    # at (Np,K,2Vh) scale, and take_along_axis to a row gather, where these
    # compare/select/reduce passes fuse.
    # Candidate positions (surface midpoints) fuse into the contraction, so
    # the (Np,K,2Vh,3) point table is never materialized.
    mvals_l, mpts_l = [], []
    pts_i = wverts[:, None] + pc_n[:, :, None, :] * (depth_iv[..., None] * 0.5)
    pts_j = jverts - pc_n[:, :, None, :] * (depth_jv[..., None] * 0.5)
    sc = scores
    for _ in range(M):
        best = sc >= jnp.max(sc, axis=-1, keepdims=True)
        best = best & (jnp.cumsum(best.astype(jnp.int32), axis=-1) == 1)
        w8 = best.astype(wverts.dtype)
        mvals_l.append(jnp.sum(w8 * sc, axis=-1))
        # Split contraction (no concat → pts_i/pts_j fuse into the reduce).
        mpts_l.append(
            jnp.sum(w8[..., :Vh, None] * pts_i, axis=2)
            + jnp.sum(w8[..., Vh:, None] * pts_j, axis=2)
        )
        sc = jnp.where(best, -BIG, sc)
    mvals = jnp.stack(mvals_l, axis=-1)                        # (Np,K,M)
    mpts = jnp.stack(mpts_l, axis=2)                           # (Np,K,M,3)
    mhit = pair_hit[..., None] & (mvals > -slop) & (mvals < BIG / 2)

    # Fallback: deepest support points when no vertex is contained
    # (edge-edge crossings contain no vertex of either hull).
    ti_f = -si_n
    tj_f = sj_n
    pi_idx = jnp.argmax(jnp.where(wmask[:, None], ti_f, -BIG), axis=-1)
    pj_idx = jnp.argmax(jnp.where(jmask, tj_f, -BIG), axis=-1)
    pi_pt = jnp.take_along_axis(wverts, pi_idx[..., None], axis=1)  # (Np,K,3)
    pj_pt = jnp.take_along_axis(
        jverts, pj_idx[..., None, None], axis=2
    )[:, :, 0, :]
    fb_pt = 0.5 * (pi_pt + pj_pt)
    none = pair_hit & ~jnp.any(mhit, axis=-1)
    mpts = mpts.at[:, :, 0, :].set(
        jnp.where(none[..., None], fb_pt, mpts[:, :, 0, :])
    )
    mvals = mvals.at[:, :, 0].set(jnp.where(none, depth, mvals[:, :, 0]))
    mhit = mhit.at[:, :, 0].set(mhit[:, :, 0] | none)

    # Slot ordering is tiled over pairs (slot = m·K + k); the solver's
    # partner tables below use the same ordering.
    pc_p = jnp.transpose(mpts, (0, 2, 1, 3)).reshape(Np, K * M, 3)
    pc_d = jnp.maximum(
        jnp.transpose(mvals, (0, 2, 1)).reshape(Np, K * M), 0.0
    )
    pc_hit = jnp.transpose(mhit, (0, 2, 1)).reshape(Np, K * M)
    pc_nrm = jnp.tile(pc_n, (1, M, 1))
    pc_partner = jnp.tile(pidx, (1, M))

    return _assemble_and_solve(
        scene, cfg, profile_stage, bodies, Np, B, K, G, M, C, single,
        wverts, wmask, owner, pvalid, x_own, pidx, pok,
        pc_p, pc_d, pc_hit, pc_nrm, pc_partner,
    )


def _assemble_and_solve(
    scene, cfg, profile_stage, bodies, Np, B, K, G, M, C, single,
    wverts, wmask, owner, pvalid, x_own, pidx, pok,
    pc_p, pc_d, pc_hit, pc_nrm, pc_partner,
):
    """Stages 3c-4: ground contacts, (Np, C) slot assembly, sleeping, the
    Jacobi solver."""
    dt = cfg.dt
    # --- 3c. ground contacts: deepest G verts below y = ground_y.
    g_pts, gd, g_hit = _ground_contacts(cfg, wverts, wmask, pvalid)
    up = jnp.zeros((Np, G, 3), wverts.dtype).at[..., 1].set(1.0)

    # --- assemble (Np, C) contact slots.
    nrm = jnp.concatenate([pc_nrm, up], axis=1)
    pts = jnp.concatenate([pc_p, g_pts], axis=1)
    dep = jnp.concatenate([pc_d, jnp.maximum(gd, 0.0)], axis=1)
    hit = jnp.concatenate([pc_hit, g_hit], axis=1)
    partner_piece = jnp.concatenate(
        [pc_partner, jnp.full((Np, G), -1, jnp.int32)], axis=1
    )
    is_static = partner_piece < 0
    partner_body = jnp.where(
        is_static, 0, owner[jnp.maximum(partner_piece, 0)]
    )

    # --- sleeping (PhysX putToSleep analogue): a sleeping body is frozen
    # and acts as STATIC toward its contact partners; it wakes when a
    # contact approaches faster than cfg.wake_speed.
    do_sleep = cfg.sleep_velocity > 0
    if do_sleep:
        asleep_in = (
            scene.sleep_frames >= cfg.sleep_frames
        ) & bodies.active                                      # (B,)
        is_static = is_static | (asleep_in[partner_body] & ~is_static)

    if profile_stage <= 3:
        return _stage_out(scene, nrm, pts, dep, hit)

    # --- 4. solver (Jacobi, A-side application only; pairs are mutual).
    inv_m = bodies.inv_mass
    inv_I = world_inv_inertia(bodies.q, bodies.inv_inertia_body)
    gravity = jnp.array([0.0, cfg.gravity, 0.0], wverts.dtype)
    grav_on = (inv_m > 0)
    if do_sleep:
        grav_on = grav_on & ~asleep_in
    v0 = bodies.v + dt * gravity * grav_on[:, None]
    w0 = bodies.w

    myb = owner                                               # (Np,)
    # Per-pair partner gather indices; ground slots read body 0 but are
    # masked static (is_static covers both pair-miss and ground slots).
    pair_body = owner[jnp.maximum(pidx, 0)]                    # (Np, K)
    # Partner body tables come from ONE per-PAIR (Np, K, 13) packed gather
    # then TILE over the M manifold slots — gathering per SLOT (Np, C)
    # moved M× the bytes for the same values (inv_I alone was a
    # (Np, C, 3, 3) gather). Tile ordering (slot = m·K + k) matches the
    # slot assembly.
    btab = jnp.concatenate(
        [bodies.x, inv_m[:, None], inv_I.reshape(B, 9), v0, w0], axis=1
    )                                                          # (B, 19)
    bt_pair = btab[pair_body]                                  # (Np, K, 19)

    def tile_slots(a):  # (Np, K, L) → (Np, C, L); ground slots zero
        t = jnp.tile(a, (1, M, 1))
        return jnp.concatenate(
            [t, jnp.zeros((Np, G) + a.shape[2:], a.dtype)], axis=1
        )

    xB = tile_slots(bt_pair[..., 0:3])                         # (Np, C, 3)
    iB_m = jnp.where(is_static, 0.0, tile_slots(bt_pair[..., 3:4])[..., 0])
    iB_I = jnp.where(
        is_static[..., None, None],
        0.0,
        tile_slots(bt_pair[..., 4:13]).reshape(Np, C, 3, 3),
    )
    rA = pts - x_own[:, None]                                 # (Np, C, 3)
    # rB is irrelevant on static/ground slots (iB and vB are masked there).
    rB = pts - xB                                             # (Np, C, 3)
    iA_m = (inv_m[myb] if not single else inv_m)[:, None]     # (Np, 1)
    iA_I = (inv_I[myb] if not single else inv_I)[:, None]     # (Np,1,3,3)

    def k_term(im, iI, r, n):
        rxn = jnp.cross(r, n)
        return im + jnp.sum(rxn * matvec3(iI, rxn), -1)

    kn = k_term(iA_m, iA_I, rA, nrm) + k_term(iB_m, iB_I, rB, nrm)
    m_eff = jnp.where(hit & (kn > 1e-12), 1.0 / jnp.maximum(kn, 1e-12), 0.0)

    def partner_vel(v, w):
        vwB = jnp.concatenate([v, w], axis=1)[pair_body]       # (Np, K, 6)
        vB_pair = vwB[..., :3]
        wB_pair = vwB[..., 3:]
        # Tile ordering over pairs (slot = m·K + k) — must match the slot
        # assembly above.
        vB = jnp.concatenate(
            [jnp.tile(vB_pair, (1, M, 1)), jnp.zeros((Np, G, 3), v.dtype)],
            axis=1,
        )
        wB = jnp.concatenate(
            [jnp.tile(wB_pair, (1, M, 1)), jnp.zeros((Np, G, 3), v.dtype)],
            axis=1,
        )
        return jnp.where(is_static[..., None], 0.0, vB + jnp.cross(wB, rB))

    def own_vel(v, w):
        if single:
            return v[:, None] + jnp.cross(
                jnp.broadcast_to(w[:, None], rA.shape), rA
            )
        return v[myb][:, None] + jnp.cross(
            jnp.broadcast_to(w[myb][:, None], rA.shape), rA
        )

    # vn0 (restitution reference) reuses the packed per-pair gather above
    # instead of a second partner-velocity gather.
    vB0 = jnp.where(
        is_static[..., None],
        0.0,
        tile_slots(bt_pair[..., 13:16])
        + jnp.cross(tile_slots(bt_pair[..., 16:19]), rB),
    )
    vn0 = jnp.sum((own_vel(v0, w0) - vB0) * nrm, axis=-1)
    bounce = -cfg.restitution * jnp.minimum(vn0 + cfg.bounce_threshold, 0.0)
    bias = (cfg.baumgarte / dt) * jnp.maximum(dep - cfg.contact_slop, 0.0)
    # Zero the bias against SLEEPING partners (ground slots keep full
    # bias): a partner going static doubles this body's share of the
    # velocity-level bias — a sustained energy injection that jolted slow
    # neighbors back over the sleep threshold and made island sleeping
    # thrash. Non-penetration impulses still hold the contact.
    lane = jnp.arange(C, dtype=jnp.int32)[None, :]
    sleeper = is_static & (lane < K * M)
    bias = jnp.where(sleeper, 0.0, bias)
    target = jnp.maximum(bounce, bias)

    # Mass splitting: per-body contact counts (pair contacts count once per
    # side; both sides carry the slot, so totals match the scatter version).
    seg = scene.seg_start
    cnt_piece = jnp.sum(hit, axis=1, keepdims=True).astype(wverts.dtype)
    if single:
        cnt_body = cnt_piece[:, 0]
    else:
        cnt_body = _segment_sums(cnt_piece, seg)[:, 0]         # (B,)
    split_body = 1.0 / jnp.maximum(cnt_body, 1.0)
    sA = (split_body[myb] if not single else split_body)[:, None, None]

    mu = cfg.dynamic_friction
    if profile_stage == 35:  # contact prep only (solver loop excluded)
        return _stage_out(scene, m_eff, target, sA, rA, rB, v0, w0)
    S = max(1, cfg.solver_substeps)
    outer = (cfg.solver_iters + S - 1) // S

    def solver_iter(carry, _):
        v, w = carry
        # Chaotic-relaxation Jacobi: partner velocities refresh once per
        # outer iteration, own-body state every substep.
        vB_full = partner_vel(v, w)
        for _ in range(S):
            vr = own_vel(v, w) - vB_full
            vn = jnp.sum(vr * nrm, axis=-1)
            lam_n = jnp.maximum(-(vn - target) * m_eff, 0.0)
            vt = vr - vn[..., None] * nrm
            vt_len = jnp.linalg.norm(vt, axis=-1)
            t_dir = vt / jnp.maximum(vt_len, 1e-9)[..., None]
            lam_t = jnp.minimum(vt_len * m_eff, mu * lam_n)
            imp = jnp.where(
                hit[..., None],
                lam_n[..., None] * nrm - lam_t[..., None] * t_dir,
                0.0,
            )                                                  # (Np, C, 3)
            piece_dv = jnp.sum(imp, axis=1) * iA_m * sA[..., 0]
            dw_terms = matvec3(
                jnp.broadcast_to(iA_I, rA.shape[:2] + (3, 3)),
                jnp.cross(rA, imp),
            )
            piece_dw = jnp.sum(dw_terms * sA, axis=1)
            if single:
                v = v + piece_dv
                w = w + piece_dw
            else:
                v = v + _segment_sums(piece_dv, seg)
                w = w + _segment_sums(piece_dw, seg)
        return (v, w), None

    (v1, w1), _ = jax.lax.scan(solver_iter, (v0, w0), None, length=outer)

    return _finish_step(
        scene, bodies, v1, w1, dt, cfg, profile_stage,
        vn0, hit, is_static, single, myb, pidx=pidx,
    )


def _finish_step(
    scene, bodies, v1, w1, dt, cfg, profile_stage,
    vn0, hit, is_static, single, myb, pidx=None,
):
    """Sleep bookkeeping + stage-5 integration."""
    if profile_stage <= 4:
        return _stage_out(scene, v1, w1)

    sleep_frames = scene.sleep_frames
    if cfg.sleep_velocity > 0:
        # Wake on fast contact approach. For a sleeping body own velocity
        # is zero, so |vn0| at its slots is the partner's approach speed.
        dist_piece = jnp.any(
            hit & ~is_static & (jnp.abs(vn0) > cfg.wake_speed), axis=1
        )
        # Island wake (PhysX wakes whole contact islands; VERDICT r3 item 8):
        # a wake source is a fast contact approach OR a contact partner
        # moving faster than wake_speed (a lateral strike has ~zero normal
        # approach toward the bodies stacked above it — the vn0 rule alone
        # never sees it). Spread sources over the CONTACT graph
        # ``wake_hops`` hops per step. Sleep ONSET stays per-body: atomic
        # island sleep was prototyped and thrashes under this Jacobi solver
        # (the per-body freeze cascade is what damps the resting limit
        # cycle — see the note below); the wake_speed threshold keeps
        # settling jitter (≲ 0.1 m/s) from propagating.
        if pidx is not None and cfg.wake_hops > 0:
            K = pidx.shape[1]
            M = max(1, cfg.manifold_points)
            pair_hit = jnp.any(
                hit[:, : K * M].reshape(-1, K, M), axis=2
            )                                              # (Np, K)
            pb = jnp.clip(pidx, 0, pidx.shape[0] - 1)
            speed2b = jnp.sum(v1 * v1, -1) + jnp.sum(w1 * w1, -1)
            fast_b = (speed2b > cfg.wake_speed**2) & bodies.active
            fast_piece = fast_b if single else fast_b[
                jnp.clip(myb, 0, scene.B - 1)
            ]
            src = dist_piece | fast_piece
            for _ in range(cfg.wake_hops):
                src = src | jnp.any(pair_hit & src[pb], axis=1)
            dist_piece = src
        if single:
            disturbed = dist_piece
        else:
            B = scene.B
            disturbed = (
                jax.ops.segment_max(
                    dist_piece.astype(jnp.int32),
                    jnp.clip(myb, 0, B - 1),
                    num_segments=B,
                )
                > 0
            )
        # Sustained-push wake (the island-sleep anchor fix, VERDICT r2
        # weak 8): a SLEEPING body whose pair contacts show approach
        # ≥ sleep_velocity for wake_push_frames consecutive steps wakes —
        # a creeping pile pushes steadily, while the Baumgarte bounce
        # cycle of a settling neighbor separates or reverses every few
        # frames and keeps resetting the counter. (Full PhysX island
        # semantics — sleep/wake whole contact islands atomically — were
        # prototyped and thrash with this Jacobi solver: the per-body
        # freeze cascade is what damps its resting limit cycle; see
        # ROADMAP.)
        push_piece = jnp.any(
            hit & ~is_static & (jnp.abs(vn0) >= cfg.sleep_velocity), axis=1
        )
        if single:
            push_b = push_piece
        else:
            push_b = (
                jax.ops.segment_max(
                    push_piece.astype(jnp.int32),
                    jnp.clip(myb, 0, scene.B - 1),
                    num_segments=scene.B,
                )
                > 0
            )
        was_asleep = sleep_frames >= cfg.sleep_frames
        push_frames = jnp.where(was_asleep & push_b, scene.push_frames + 1, 0)
        disturbed = disturbed | (push_frames >= cfg.wake_push_frames)
        speed2 = jnp.sum(v1 * v1, -1) + jnp.sum(w1 * w1, -1)
        slow = speed2 < cfg.sleep_velocity**2
        cnt = jnp.where(
            disturbed,
            0,
            jnp.where(
                slow,
                jnp.minimum(sleep_frames + 1, cfg.sleep_frames + 1),
                0,
            ),
        )
        asleep = (cnt >= cfg.sleep_frames) & ~disturbed & bodies.active
        v1 = jnp.where(asleep[:, None], 0.0, v1)
        w1 = jnp.where(asleep[:, None], 0.0, w1)
        sleep_frames = cnt
    else:
        push_frames = scene.push_frames

    return _integrate(
        scene, bodies, v1, w1, dt, sleep_frames, push_frames
    )


def _integrate(
    scene, bodies, v1, w1, dt, sleep_frames, push_frames
):
    """Stage 5: symplectic Euler + quaternion renormalization."""
    import dataclasses

    act = bodies.active
    v1 = jnp.where(act[:, None], v1, 0.0)
    w1 = jnp.where(act[:, None], w1, 0.0)
    x1 = bodies.x + dt * v1
    q1 = quat_integrate(bodies.q, w1, dt)

    new_bodies = type(bodies)(
        x=x1, q=q1, v=v1, w=w1,
        inv_mass=bodies.inv_mass,
        inv_inertia_body=bodies.inv_inertia_body,
        active=act,
    )
    return dataclasses.replace(
        scene, bodies=new_bodies, sleep_frames=sleep_frames,
        push_frames=push_frames,
    )
