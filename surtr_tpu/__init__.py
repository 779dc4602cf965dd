"""surtr_tpu — a real-time fracture-simulation framework on the accelerator.

Rebuild of the capabilities of W298/Surtr (VMACH volumetric approximate convex
decomposition + rigid-body dynamics + shadow-mapped rendering) as batched,
jitted JAX/Pallas programs. See DESIGN.md and SURVEY.md at the repo root.
"""

from surtr_tpu.config import FractureConfig, PhysicsConfig, RenderConfig, SceneConfig
from surtr_tpu.types import ConvexPoly, TriSoup, RigidState

__version__ = "0.1.0"

__all__ = [
    "FractureConfig",
    "PhysicsConfig",
    "RenderConfig",
    "SceneConfig",
    "ConvexPoly",
    "TriSoup",
    "RigidState",
]
