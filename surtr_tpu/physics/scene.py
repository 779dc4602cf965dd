"""Physics scene construction from fracture output.

Mirrors the reference's InitCompound (/root/reference/Src/Surtr.cpp:2499-2529):
each compound (bind group) becomes one rigid dynamic body whose shapes are its
pieces' convexes ("exclusive convex shapes on one new PxRigidDynamic"), with
mass/inertia from geometry at density 10 (updateMassAndInertia(10.0),
Surtr.cpp:2520). Piece hulls are stored in body frame (COM at origin).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from surtr_tpu.config import PhysicsConfig
from surtr_tpu.fracture.types import PieceSet
from surtr_tpu.ops.moments import inertia
from surtr_tpu.types import RigidState


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PhysicsScene:
    """bodies: (B,) rigid states; pieces: (Np,) convex shapes owned by bodies.

    piece_verts are deduplicated hull corner pools in body frame; piece_planes
    are body-frame face planes (used for SAT axes and scene queries).
    """

    bodies: RigidState
    piece_owner: jax.Array   # (Np,) i32 body index (or -1); SORTED ascending
    piece_valid: jax.Array   # (Np,) bool
    piece_verts: jax.Array   # (Np, Vh, 3) body-frame hull verts
    piece_vmask: jax.Array   # (Np, Vh) bool
    piece_planes: jax.Array  # (Np, F, 4) body-frame planes
    piece_pmask: jax.Array   # (Np, F) bool
    piece_edges: jax.Array   # (Np, Ne, 3) distinct body-frame edge directions
    piece_emask: jax.Array   # (Np, Ne) bool
    seg_start: jax.Array     # (B+1,) piece-run offsets per body (sorted owner)
    sleep_frames: jax.Array  # (B,) i32 consecutive slow steps (body sleeping,
                             # PhysX putToSleep analogue; SURVEY §2.2 T2)
    push_frames: jax.Array   # (B,) i32 consecutive steps a SLEEPING body's
                             # contacts showed sustained approach — wakes
                             # the sleeper after wake_push_frames (the
                             # creeping-pile anchor fix; bounce cycles
                             # reset it at every separation/turnaround)

    @property
    def B(self) -> int:
        return self.bodies.N

    @property
    def Np(self) -> int:
        return self.piece_owner.shape[-1]


def _dedup_verts(fv: jax.Array, sm: jax.Array, Vh: int):
    """(F, S, 3) face soup → (Vh, 3) first-occurrence unique corner pool.

    Exact-duplicate removal (positions are bitwise-shared across faces)."""
    pts = fv.reshape(-1, 3)
    m = sm.reshape(-1)
    n = pts.shape[0]
    eq = jnp.all(pts[:, None] == pts[None], axis=-1) & m[None, :] & m[:, None]
    idx = jnp.arange(n)
    first = jnp.min(jnp.where(eq, idx[None, :], n), axis=1)
    is_first = m & (first == idx)
    tgt = jnp.cumsum(is_first.astype(jnp.int32)) - is_first.astype(jnp.int32)
    # Scatter-free compaction: one-hot (Vh, n) contraction instead of a
    # batched scatter.
    keep = is_first & (tgt < Vh)
    onehot = (
        keep[None, :] & (tgt[None, :] == jnp.arange(Vh)[:, None])
    ).astype(fv.dtype)
    out = jax.lax.dot(
        onehot, pts, precision=jax.lax.Precision.HIGHEST
    )                                                        # (Vh, 3) exact
    cnt = jnp.minimum(jnp.sum(is_first), Vh)
    return out, jnp.arange(Vh) < cnt


def _edge_dirs(poly_fv: jax.Array, nv: jax.Array, Ne: int):
    """Up to ``Ne`` distinct edge directions of one convex (greedy max-min
    angular selection over the face-loop edges). Gather-free (one-hot picks).

    poly_fv: (F, S, 3) face loops; nv: (F,). Returns ((Ne, 3) unit dirs in
    canonical sign, (Ne,) mask). Feeds the SAT edge-cross axes — the axis
    family PhysX covers via full convex-convex SAT (no reference source;
    SURVEY §7 hard-part 5)."""
    if Ne == 0:  # edge axes disabled (config.max_edge_dirs=0)
        return (
            jnp.zeros((0, 3), poly_fv.dtype),
            jnp.zeros((0,), bool),
        )
    F, S = poly_fv.shape[0], poly_fv.shape[1]
    slot = jnp.arange(S, dtype=jnp.int32)
    m = slot[None, :] < nv[:, None]
    rolled = jnp.concatenate([poly_fv[:, 1:], poly_fv[:, :1]], axis=1)
    is_last = slot[None, :] == nv[:, None] - 1
    v_next = jnp.where(is_last[..., None], poly_fv[:, :1], rolled)
    d = (v_next - poly_fv).reshape(F * S, 3)
    valid = m.reshape(F * S)
    ln = jnp.linalg.norm(d, axis=-1)
    valid = valid & (ln > 1e-9)
    u = d / jnp.maximum(ln, 1e-30)[:, None]
    # Canonical sign: first significant component positive (antipodal dirs
    # coincide).
    sx = jnp.where(jnp.abs(u[:, 0]) > 1e-4, jnp.sign(u[:, 0]), 0.0)
    sy = jnp.where(jnp.abs(u[:, 1]) > 1e-4, jnp.sign(u[:, 1]), 0.0)
    sz = jnp.where(u[:, 2] >= 0, 1.0, -1.0)
    s = jnp.where(sx != 0, sx, jnp.where(sy != 0, sy, sz))
    u = u * s[:, None]

    chosen, cmask = [], []
    # min over chosen of (1 - |u·c|); large before any pick.
    dissim = jnp.where(valid, 2.0, -1.0)
    for _ in range(Ne):
        score = jnp.where(valid, dissim, -1.0)
        best = score >= jnp.max(score, axis=-1, keepdims=True)
        best = best & (jnp.cumsum(best.astype(jnp.int32)) == 1)
        w = best.astype(u.dtype)
        c = jnp.sum(w[:, None] * u, axis=0)
        ok = jnp.max(score) > 2e-2  # skip near-duplicates of chosen dirs
        chosen.append(c)
        cmask.append(ok)
        dissim = jnp.minimum(
            dissim, 1.0 - jnp.abs(jnp.sum(u * c[None], axis=-1))
        )
    return jnp.stack(chosen), jnp.stack(cmask)


@functools.partial(jax.jit, static_argnames=("cfg", "max_bodies"))
def build_scene(
    pieces: PieceSet, cfg: PhysicsConfig, max_bodies: int | None = None
) -> PhysicsScene:
    """Create rigid bodies from piece groups (InitCompound semantics).

    New bodies start at rest — the reference transfers no velocity to
    fragments (createRigidDynamic with pose only, Surtr.cpp:2507).
    """
    P = pieces.P
    B = max_bodies if max_bodies is not None else P
    Vh = cfg.max_hull_verts

    mass_p, com_p, I_p = inertia(pieces.convex, density=cfg.density)
    mass_p = jnp.where(pieces.valid, mass_p, 0.0)
    gid = jnp.where(pieces.valid, pieces.group, B)  # invalid → dump row B

    # Aggregate per group: total mass, COM.
    seg = lambda x: jax.ops.segment_sum(x, gid, num_segments=B + 1)[:B]
    m_b = seg(mass_p)
    com_b = seg(com_p * mass_p[:, None]) / jnp.maximum(m_b, 1e-12)[:, None]

    # Inertia about the body COM (parallel axis per piece).
    d = com_p - com_b[jnp.clip(gid, 0, B - 1)]
    d2 = jnp.sum(d * d, axis=-1)
    eye = jnp.eye(3)
    shift = mass_p[:, None, None] * (
        d2[:, None, None] * eye - d[:, :, None] * d[:, None, :]
    )
    I_b = seg(I_p + shift)
    body_valid = m_b > 0

    inv_m = jnp.where(body_valid, 1.0 / jnp.maximum(m_b, 1e-12), 0.0)
    # Robust inverse for (possibly singular) padded rows.
    I_safe = jnp.where(body_valid[:, None, None], I_b, eye)
    inv_I = jnp.linalg.inv(I_safe + 1e-9 * eye)
    inv_I = jnp.where(body_valid[:, None, None], inv_I, 0.0)

    bodies = RigidState(
        x=com_b,
        q=jnp.zeros((B, 4)).at[:, 0].set(1.0),
        v=jnp.zeros((B, 3)),
        w=jnp.zeros((B, 3)),
        inv_mass=inv_m,
        inv_inertia_body=inv_I,
        active=body_valid,
    )

    # Piece hulls in body frame.
    shift_p = com_b[jnp.clip(gid, 0, B - 1)]
    fv_local = pieces.convex.face_verts - shift_p[:, None, None, :]
    verts, vmask = jax.vmap(lambda fv, sm: _dedup_verts(fv, sm, Vh))(
        fv_local, pieces.convex.slot_mask()
    )
    n = pieces.convex.planes[..., :3]
    dpl = pieces.convex.planes[..., 3:4] + jnp.sum(
        n * shift_p[:, None, :], axis=-1, keepdims=True
    )
    planes_local = jnp.concatenate([n, dpl], axis=-1)

    edges, emask = jax.vmap(
        lambda fv, nv: _edge_dirs(fv, nv, cfg.max_edge_dirs)
    )(fv_local, pieces.convex.n_verts)

    # Sort pieces by owner so per-body reductions are segmented cumsums
    # (the step is scatter-free; see physics/step.py docstring).
    owner_raw = jnp.where(pieces.valid, pieces.group, -1).astype(jnp.int32)
    sort_key = jnp.where(owner_raw >= 0, owner_raw, B)
    order = jnp.argsort(sort_key)
    key_sorted = sort_key[order]
    seg_start = jnp.searchsorted(
        key_sorted, jnp.arange(B + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    # ONE packed (P, D) gather for every per-piece field instead of six
    # separate ``[order]`` gathers. Bools ride as 0/1 f32, the owner id as
    # f32 (exact for B ≤ 2^24).
    F = planes_local.shape[1]
    Ne = edges.shape[1]
    f32 = jnp.float32
    payload = jnp.concatenate(
        [
            jnp.where(vmask[..., None], verts, 0.0).reshape(P, Vh * 3),
            (vmask & pieces.valid[:, None]).astype(f32),
            planes_local.reshape(P, F * 4),
            (pieces.convex.face_mask() & pieces.valid[:, None]).astype(f32),
            edges.reshape(P, Ne * 3),
            (emask & pieces.valid[:, None]).astype(f32),
            owner_raw.astype(f32)[:, None],
            pieces.valid.astype(f32)[:, None],
        ],
        axis=1,
    )[order]
    o = 0
    def take(n):
        nonlocal o
        s = payload[:, o:o + n]
        o += n
        return s
    verts_s = take(Vh * 3).reshape(P, Vh, 3)
    vmask_s = take(Vh) > 0.5
    planes_s = take(F * 4).reshape(P, F, 4)
    pmask_s = take(F) > 0.5
    edges_s = take(Ne * 3).reshape(P, Ne, 3)
    emask_s = take(Ne) > 0.5
    owner_sorted = take(1)[:, 0].astype(jnp.int32)
    valid_s = take(1)[:, 0] > 0.5
    # A piece whose body carries no mass (all-degenerate group) must not
    # exist for queries/contacts — zero-mass "static" debris would block
    # raycasts and shade the impact sphere (defense in depth; the fracture
    # pipeline also culls empty-hull candidates).
    valid_s = valid_s & (owner_sorted >= 0) & body_valid[
        jnp.clip(owner_sorted, 0, B - 1)
    ]
    # Bodies with pieces beyond B (invalid) are excluded: clamp final edge.
    return PhysicsScene(
        bodies=bodies,
        piece_owner=owner_sorted,
        piece_valid=valid_s,
        piece_verts=verts_s,
        piece_vmask=vmask_s,
        piece_planes=planes_s,
        piece_pmask=pmask_s,
        piece_edges=edges_s,
        piece_emask=emask_s,
        seg_start=seg_start,
        sleep_frames=jnp.zeros((B,), jnp.int32),
        push_frames=jnp.zeros((B,), jnp.int32),
    )


def piece_world_verts(scene: PhysicsScene):
    """World-space hull verts per piece: ((Np, Vh, 3), mask)."""
    from surtr_tpu.ops.linalg import rot_points
    from surtr_tpu.physics.rigid import quat_to_mat

    owner = jnp.clip(scene.piece_owner, 0, scene.B - 1)
    R = quat_to_mat(scene.bodies.q)[owner]            # (Np, 3, 3)
    x = scene.bodies.x[owner]
    w = rot_points(R, scene.piece_verts) + x[:, None]
    return w, scene.piece_vmask
