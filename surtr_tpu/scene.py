"""The scene API — the framework's user surface, mirroring the reference app's
flow (SURVEY §3): load a model → prepare the initial compound → step physics
at a fixed 1/120 s → fire impacts that refracture compounds → read fragments
and trajectories (→ render, surtr_tpu.render).

Host-side orchestration only; every hot operation is a jitted device call.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from surtr_tpu.config import SceneConfig
from surtr_tpu.fracture.pipeline import do_fracture, prepare_fracture
from surtr_tpu.fracture.types import FractureContext, PieceSet
from surtr_tpu.io.models import get_model, sphere_point_cloud
from surtr_tpu.physics.queries import raycast, sphere_overlap
from surtr_tpu.physics.rigid import quat_to_mat
from surtr_tpu.physics.scene import PhysicsScene, build_scene
from surtr_tpu.physics.step import physics_step
from surtr_tpu.types import ConvexPoly


@jax.jit
def _bake_pieces(pieces: PieceSet, phys: PhysicsScene, x0: jax.Array) -> PieceSet:
    """Apply each piece's current rigid transform to its stored geometry —
    the analogue of baking world matrices before fracture
    (ExecuteFractureRoutine, Surtr.cpp:1846-1851).

    Stored geometry is in the world frame of the last rebuild; the current
    transform is p ↦ R_b (p − x0_b) + x_b.
    """
    from surtr_tpu.ops.linalg import matvec3, rot_points

    B = phys.B
    P = pieces.P
    owner = jnp.clip(jnp.where(pieces.valid, pieces.group, 0), 0, B - 1)
    R = quat_to_mat(phys.bodies.q)[owner]                     # (P, 3, 3)
    t = phys.bodies.x[owner] - matvec3(R, x0[owner])
    fv = rot_points(
        R, pieces.convex.face_verts.reshape(P, -1, 3)
    ).reshape(pieces.convex.face_verts.shape) + t[:, None, None, :]
    n = rot_points(R, pieces.convex.planes[..., :3])
    d = pieces.convex.planes[..., 3:4] - jnp.sum(
        n * t[:, None, :], axis=-1, keepdims=True
    )
    mesh = rot_points(R, pieces.mesh.reshape(P, -1, 3)).reshape(
        pieces.mesh.shape
    ) + t[:, None, None, :]
    return PieceSet(
        convex=ConvexPoly(fv, pieces.convex.n_verts, jnp.concatenate([n, d], -1)),
        mesh=mesh,
        mesh_valid=pieces.mesh_valid,
        valid=pieces.valid,
        group=pieces.group,
        tag=pieces.tag,
    )


class Scene:
    """One simulated world: compounds of convex pieces + rigid dynamics.

    Example:
        sc = Scene("cube")
        sc.step(120)                       # 1 second at 1/120
        sc.fire_impact((0, 10, 0), (0, -1, 0))
        frames = sc.positions()
    """

    def __init__(
        self,
        model: str | tuple = "cube",
        config: SceneConfig | None = None,
        spawn: Sequence[float] = (0.0, 5.0, 0.0),
        seed: int | None = None,
    ):
        self.cfg = config or SceneConfig()
        fcfg = self.cfg.fracture
        if isinstance(model, str):
            verts, tris = get_model(model)
        else:
            verts, tris = model
        verts = np.asarray(verts, np.float32) + np.asarray(spawn, np.float32)
        # Convex-model dispatch: the legacy refit-face caps are EXACT for
        # convex solids (tested vs the f64 oracle), while the exact-caps
        # machinery (ops/caps.py) costs real time per event — auto-select
        # it only when the model is actually concave (hull volume exceeds
        # the mesh volume). Equivalence, not a quality knob.
        if fcfg.exact_caps:
            try:
                from scipy.spatial import ConvexHull

                hull_vol = ConvexHull(np.asarray(verts, np.float64)).volume
                mesh_vol = abs(
                    float(
                        np.einsum(
                            "ij,ij->i",
                            verts[tris[:, 0]].astype(np.float64),
                            np.cross(
                                verts[tris[:, 1]].astype(np.float64),
                                verts[tris[:, 2]].astype(np.float64),
                            ),
                        ).sum()
                        / 6.0
                    )
                )
                if mesh_vol > 0 and hull_vol <= mesh_vol * 1.01:
                    import dataclasses as _dc

                    fcfg = _dc.replace(fcfg, exact_caps=False)
                    self.cfg = _dc.replace(self.cfg, fracture=fcfg)
            except Exception:
                pass  # keep exact caps if the hull test is unavailable
        self.key = jax.random.PRNGKey(seed if seed is not None else fcfg.seed)

        corners = jnp.asarray(verts[tris])
        self.pieces, self.ctx, self.prepare_metrics = prepare_fracture(
            jnp.asarray(verts),
            jnp.ones(len(verts), bool),
            corners,
            jnp.ones(len(tris), bool),
            jnp.asarray(sphere_point_cloud()),
            self.key,
            fcfg,
        )
        self._rebuild(old_phys=None)
        self.time = 0.0
        self.events = []

    # ------------------------------------------------------------------
    def _rebuild(self, old_phys: PhysicsScene | None):
        """(Re)create rigid bodies from pieces; transfer velocities via tags
        (untouched compounds keep momentum; new fragments spawn at rest)."""
        phys = build_scene(self.pieces, self.cfg.physics)
        if old_phys is not None:
            phys = _transfer_velocities(
                phys, old_phys, self.pieces.group, self.pieces.tag,
                self.pieces.valid,
            )
        self.phys = phys
        self._x0 = phys.bodies.x

    def step(self, n: int = 1):
        for _ in range(n):
            self.phys = physics_step(self.phys, self.cfg.physics)
        self.time += n * self.cfg.physics.dt
        return self

    def interactive_frame(self, origin, direction, eye=(8.0, 6.0, 8.0),
                          target=(0.0, 1.0, 0.0)):
        """One fused impact→refracture→step→render dispatch (module-level
        ``interactive_frame``); returns (image, fracture metrics)."""
        pieces, phys, x0, img, met = interactive_frame(
            self.pieces, self.phys, self._x0, self.ctx,
            jnp.asarray(origin, jnp.float32),
            jnp.asarray(direction, jnp.float32),
            jnp.asarray(eye, jnp.float32),
            jnp.asarray(target, jnp.float32),
            cfg=self.cfg,
        )
        self.pieces, self.phys, self._x0 = pieces, phys, x0
        self.time += self.cfg.physics.dt
        self.events.append({"impact": np.asarray(met.get("impact", 0))
                            if isinstance(met, dict) else None,
                            "targets": "fused"})
        return img, met

    # ------------------------------------------------------------------
    def world_pieces(self) -> PieceSet:
        """Pieces baked to current world coordinates."""
        return _bake_pieces(self.pieces, self.phys, self._x0)

    def positions(self) -> np.ndarray:
        return np.asarray(self.phys.bodies.x)

    def num_bodies(self) -> int:
        return int(self.phys.bodies.active.sum())

    def num_pieces(self) -> int:
        return int(self.pieces.valid.sum())

    def total_volume(self) -> float:
        from surtr_tpu.ops.moments import moments

        v, _ = moments(self.pieces.convex)
        return float(jnp.where(self.pieces.valid, v, 0).sum())

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Structured per-step observability (SURVEY §5 metrics: fragment
        count, volumes, body velocities) — the analogue of the reference's
        imgui result panel + debug prints."""
        import numpy as np

        from surtr_tpu.ops.moments import moments

        act = np.asarray(self.phys.bodies.active)
        v = np.asarray(self.phys.bodies.v)[act]
        w = np.asarray(self.phys.bodies.w)[act]
        vols, _ = moments(self.pieces.convex)
        inv_m = np.asarray(self.phys.bodies.inv_mass)[act]
        m = np.where(inv_m > 0, 1.0 / np.maximum(inv_m, 1e-12), 0.0)
        ke = float(0.5 * (m * (v**2).sum(1)).sum())
        return {
            "time": self.time,
            "pieces": self.num_pieces(),
            "bodies": int(act.sum()),
            "total_volume": float(
                jnp.where(self.pieces.valid, vols, 0).sum()
            ),
            "kinetic_energy": ke,
            "max_speed": float(np.abs(v).max()) if len(v) else 0.0,
            "max_spin": float(np.abs(w).max()) if len(w) else 0.0,
            "events": len(self.events),
        }

    def render(self, eye=(8.0, 6.0, 8.0), target=(0.0, 1.0, 0.0),
               light_dir=(-0.4, -1.0, -0.3), wireframe=False,
               highlight_last_impact=True):
        """Shadow-mapped frame of the current state (reference render passes,
        Surtr.cpp:370-664). Returns (H, W, 3) float image."""
        return render_pieces_frame(
            self.world_pieces(),
            jnp.asarray(bool(highlight_last_impact and self.events)),
            jnp.asarray(eye, jnp.float32),
            jnp.asarray(target, jnp.float32),
            jnp.asarray(light_dir, jnp.float32),
            rcfg=self.cfg.render,
            ground_y=self.cfg.physics.ground_y,
            wireframe=wireframe,
        )

    # ------------------------------------------------------------------
    def fire_impact(self, origin, direction, partial: bool | None = None):
        """Raycast into the scene and fracture what it hits (OnMouseDown →
        ExecuteFractureRoutine, Surtr.cpp:178-254).

        Returns a metrics dict (empty if the ray misses)."""
        fcfg = self.cfg.fracture
        origin = jnp.asarray(origin, jnp.float32)
        direction = jnp.asarray(direction, jnp.float32)
        direction = direction / jnp.linalg.norm(direction)
        pidx, t = raycast(self.phys, origin, direction)
        if int(pidx) < 0:
            return {}
        impact = origin + direction * (t + fcfg.target_adder)

        if fcfg.radial_mode:
            ov = sphere_overlap(self.phys, impact, fcfg.impact_radius / 2.0)
            targets = np.unique(
                np.asarray(self.phys.piece_owner)[np.asarray(ov)]
            ).tolist()
        else:
            targets = [int(self.phys.piece_owner[int(pidx)])]
        # Only dynamic bodies (mass filter, Surtr.cpp:226-233).
        targets = [
            b for b in targets
            if b >= 0 and float(self.phys.bodies.inv_mass[b]) > 0
        ]
        return self.impact_at(impact, targets, partial=partial)

    def impact_at(self, impact, target_bodies, partial: bool | None = None):
        """Fracture the given bodies at an impact position."""
        fcfg = self.cfg.fracture
        partial = fcfg.partial_fracture if partial is None else partial
        if not len(target_bodies):
            return {}
        impact = jnp.asarray(impact, jnp.float32)

        # Bake current transforms, tag pieces with their current body id.
        baked = _bake_pieces(self.pieces, self.phys, self._x0)
        baked = PieceSet(
            convex=baked.convex,
            mesh=baked.mesh,
            mesh_valid=baked.mesh_valid,
            valid=baked.valid,
            group=baked.group,
            tag=jnp.where(baked.valid, baked.group, -1),
        )
        old_phys = self.phys
        # All affected bodies fracture in ONE dispatch: target mask over
        # pieces (tags carry the pre-fracture body ids).
        tb = jnp.asarray(
            np.asarray(target_bodies, np.int32).reshape(-1), jnp.int32
        )
        target_mask = baked.valid & jnp.any(
            baked.tag[:, None] == tb[None, :], axis=1
        )
        pieces, met = do_fracture(
            baked, self.ctx, impact, target_mask, fcfg, partial=partial
        )
        metrics = [{k: np.asarray(v) for k, v in met.items()}]
        self.pieces = pieces
        self._rebuild(old_phys=old_phys)
        self.events.append({"impact": np.asarray(impact), "targets": target_bodies})
        return {
            "targets": target_bodies,
            "impact": np.asarray(impact),
            "metrics": metrics,
        }


@functools.partial(
    jax.jit, static_argnames=("rcfg", "ground_y", "wireframe")
)
def render_pieces_frame(
    world: PieceSet, highlight, eye, target, light_dir,
    rcfg, ground_y: float, wireframe: bool = False,
):
    """Shadow-mapped frame of world-space pieces — the jittable core of
    ``Scene.render`` (reference passes, Surtr.cpp:370-664)."""
    from surtr_tpu.render.camera import light_view_proj, look_at, perspective
    from surtr_tpu.render.raster import render_scene

    P, T = world.P, world.T
    tris = world.mesh.reshape(P * T, 3, 3)
    tvalid = world.mesh_valid.reshape(P * T)
    # Ground plane (reference ground at y=-2, Surtr.cpp:1523-1528) as a
    # single quad — the rasterizer near-clips partial triangles.
    gy = ground_y
    g = 48.0
    ground = jnp.asarray(
        [
            [[-g, gy, -g], [-g, gy, g], [g, gy, g]],
            [[-g, gy, -g], [g, gy, g], [g, gy, -g]],
        ],
        jnp.float32,
    )
    ng = ground.shape[0]
    tris = jnp.concatenate([tris, ground])
    tvalid = jnp.concatenate([tvalid, jnp.ones(ng, bool)])
    # Per-piece pseudo-random stone tint (reference default 0.25 gray).
    pid = jnp.repeat(jnp.arange(P, dtype=jnp.uint32), T)
    h = (pid * jnp.uint32(2654435761)) >> jnp.uint32(24)
    tint = 0.38 + (h.astype(jnp.float32) / 255.0) * 0.22
    colors = jnp.stack([tint, tint, tint], axis=-1)
    # Debug coloring of the last impact's fragments (the reference's
    # DebugValue red tint, Shader.hlsli:86-89).
    fresh = (
        jnp.repeat(world.tag < 0, T)
        & jnp.repeat(world.valid, T)
        & highlight
    )
    red = jnp.stack([tint * 1.8 + 0.15, tint * 0.7, tint * 0.7], axis=-1)
    colors = jnp.where(fresh[:, None], red, colors)
    gcol = jnp.full((ng, 3), 0.45, jnp.float32)
    colors = jnp.concatenate([colors, gcol])

    view = look_at(eye, target)
    proj = perspective(rcfg.fov_deg, rcfg.width / rcfg.height,
                       rcfg.z_near, rcfg.z_far)
    lvp = light_view_proj(light_dir, (0.0, 1.0, 0.0), 14.0)
    img, _ = render_scene(
        tris, tvalid, colors,
        jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST),
        lvp, light_dir,
        W=rcfg.width, H=rcfg.height, shadow_size=rcfg.shadow_size,
        cfg=rcfg, wireframe=wireframe,
    )
    return img


@functools.partial(jax.jit, static_argnames=("cfg",))
def interactive_frame(
    pieces: PieceSet, phys: PhysicsScene, x0, ctx, origin, direction,
    eye, target, cfg: SceneConfig,
):
    """ONE fused dispatch for the full interactive loop: raycast impact →
    radial target selection → bake → refracture → rigid-body rebuild with
    velocity transfer → physics step → shadow-mapped render.

    The reference's Tick is one loop (OnMouseDown → ExecuteFractureRoutine
    → simulate → Render, Surtr.cpp:123-131, 178-254); this is its
    single-dispatch analogue (a ray that misses degrades to
    step+render with an empty target mask).

    Returns (pieces', phys', x0', img, metrics).
    """
    fcfg, pcfg = cfg.fracture, cfg.physics
    direction = direction / jnp.maximum(jnp.linalg.norm(direction), 1e-12)
    pidx, t = raycast(phys, origin, direction)
    hit = pidx >= 0
    impact = origin + direction * (t + fcfg.target_adder)
    B = phys.B

    if fcfg.radial_mode:
        ov = sphere_overlap(phys, impact, fcfg.impact_radius / 2.0)
    else:
        ov = jnp.arange(phys.Np) == jnp.clip(pidx, 0, phys.Np - 1)
    own_ok = phys.piece_owner >= 0
    bt = (
        jax.ops.segment_max(
            (ov & own_ok).astype(jnp.int32),
            jnp.clip(phys.piece_owner, 0, B - 1),
            num_segments=B,
        )
        > 0
    )
    # dynamic bodies only (mass filter, Surtr.cpp:226-233)
    bt = bt & (phys.bodies.inv_mass > 0) & hit

    baked = _bake_pieces(pieces, phys, x0)
    baked = PieceSet(
        convex=baked.convex,
        mesh=baked.mesh,
        mesh_valid=baked.mesh_valid,
        valid=baked.valid,
        group=baked.group,
        tag=jnp.where(baked.valid, baked.group, -1),
    )
    tmask = (
        baked.valid
        & (baked.group >= 0)
        & bt[jnp.clip(baked.group, 0, B - 1)]
    )
    pieces2, met = do_fracture(
        baked, ctx, impact, tmask, fcfg, partial=fcfg.partial_fracture
    )
    phys2 = build_scene(pieces2, cfg.physics)
    phys2 = _transfer_velocities(
        phys2, phys, pieces2.group, pieces2.tag, pieces2.valid
    )
    x0_new = phys2.bodies.x
    phys3 = physics_step(phys2, pcfg)

    world = _bake_pieces(pieces2, phys3, x0_new)
    img = render_pieces_frame(
        world, jnp.asarray(True), eye, target,
        jnp.asarray([-0.4, -1.0, -0.3], jnp.float32),
        rcfg=cfg.render, ground_y=pcfg.ground_y,
    )
    return pieces2, phys3, x0_new, img, met


@jax.jit
def _transfer_velocities(
    phys: PhysicsScene,
    old: PhysicsScene,
    group: jax.Array,
    tag: jax.Array,
    valid: jax.Array,
):
    """New body velocity = old tagged body's velocity at the new COM; bodies
    made only of fresh fragments (tag −1 everywhere) stay at rest."""
    B = phys.B
    gid = jnp.where(valid & (group >= 0), group, B)
    t = jnp.where(valid, tag, -1)
    # Representative old body per new group: max tag (−1 if none).
    rep = (
        jnp.full((B + 1,), -1, jnp.int32).at[gid].max(t, mode="drop")[:B]
    )
    has = rep >= 0
    repc = jnp.clip(rep, 0, old.B - 1)
    v_old = old.bodies.v[repc]
    w_old = old.bodies.w[repc]
    x_old = old.bodies.x[repc]
    v_new = v_old + jnp.cross(w_old, phys.bodies.x - x_old)
    v = jnp.where(has[:, None], v_new, 0.0)
    w = jnp.where(has[:, None], w_old, 0.0)
    import dataclasses

    bodies = type(phys.bodies)(
        x=phys.bodies.x,
        q=phys.bodies.q,
        v=jnp.where(phys.bodies.active[:, None], v, 0.0),
        w=jnp.where(phys.bodies.active[:, None], w, 0.0),
        inv_mass=phys.bodies.inv_mass,
        inv_inertia_body=phys.bodies.inv_inertia_body,
        active=phys.bodies.active,
    )
    return dataclasses.replace(phys, bodies=bodies)
