"""Rigid-body dynamics — the on-device replacement for NVIDIA PhysX
(SURVEY §2.2 T2): broadphase, convex contacts, impulse solving, symplectic
integration, scene queries, all inside one jitted step."""

from surtr_tpu.physics.scene import PhysicsScene, build_scene
from surtr_tpu.physics.step import physics_step

__all__ = ["PhysicsScene", "build_scene", "physics_step"]
