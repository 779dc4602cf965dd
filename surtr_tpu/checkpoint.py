"""Checkpoint / resume.

The reference has none (SURVEY §5 — device-loss recovery resets the scene).
Here the whole simulation state is a pytree (pieces, fracture context, rigid
states), so snapshot/restore is a flat array dump: ``save_scene`` /
``load_scene`` via np.savez (orbax-free so tests need no async machinery;
the arrays are identical to what orbax would store).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np


def _flatten_with_paths(tree):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in leaves:
        key = "/".join(
            getattr(p, "name", None) or str(getattr(p, "idx", p)) for p in path
        )
        out[key] = np.asarray(leaf)
    return out, treedef


def save_scene(path: str, scene) -> None:
    """Snapshot a surtr_tpu.scene.Scene to an .npz file."""
    state = {
        "pieces": scene.pieces,
        "ctx": scene.ctx,
        "bodies": scene.phys.bodies,
        "x0": scene._x0,
    }
    arrays = {}
    for name, tree in state.items():
        flat, _ = _flatten_with_paths(tree)
        for k, v in flat.items():
            arrays[f"{name}:{k}"] = v
    arrays["meta:time"] = np.asarray(scene.time)
    arrays["meta:key"] = np.asarray(scene.key)
    np.savez_compressed(path, **arrays)


def load_scene(path: str, config=None):
    """Restore a Scene from an .npz snapshot (physics piece tables are
    rebuilt from the pieces — they are derived state)."""
    from surtr_tpu.config import SceneConfig
    from surtr_tpu.fracture.types import FractureContext, PieceSet
    from surtr_tpu.physics.scene import build_scene
    from surtr_tpu.scene import Scene
    from surtr_tpu.types import ConvexPoly, RigidState

    data = np.load(path)
    g = lambda k: jnp.asarray(data[k])

    def poly(prefix):
        return ConvexPoly(
            g(f"{prefix}/face_verts"), g(f"{prefix}/n_verts"), g(f"{prefix}/planes")
        )

    pieces = PieceSet(
        convex=poly("pieces:convex"),
        mesh=g("pieces:mesh"),
        mesh_valid=g("pieces:mesh_valid"),
        valid=g("pieces:valid"),
        group=g("pieces:group"),
        tag=g("pieces:tag"),
    )
    ctx = FractureContext(
        bb_center=g("ctx:bb_center"),
        bb_min=g("ctx:bb_min"),
        bb_max=g("ctx:bb_max"),
        max_axis_scale=g("ctx:max_axis_scale"),
        partial_pattern=poly("ctx:partial_pattern"),
        general_pattern=poly("ctx:general_pattern"),
        sphere_cloud=g("ctx:sphere_cloud"),
    )
    bodies = RigidState(
        x=g("bodies:x"), q=g("bodies:q"), v=g("bodies:v"), w=g("bodies:w"),
        inv_mass=g("bodies:inv_mass"),
        inv_inertia_body=g("bodies:inv_inertia_body"),
        active=g("bodies:active"),
    )

    sc = Scene.__new__(Scene)
    sc.cfg = config or SceneConfig()
    sc.pieces = pieces
    sc.ctx = ctx
    sc.key = g("meta:key")
    sc.time = float(data["meta:time"])
    sc.events = []
    sc.prepare_metrics = {}
    phys = build_scene(pieces, sc.cfg.physics)
    # Restore the dynamic body state on top of the rebuilt tables.
    phys = dataclasses.replace(phys, bodies=bodies)
    sc.phys = phys
    sc._x0 = g("x0:")  # bare-array entry: empty pytree path suffix
    return sc
