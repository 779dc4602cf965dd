"""Float64 NumPy oracle — an independent CPU implementation of the VMACH
geometry semantics, structured like the reference's adjacency-polyhedron
algorithms (Poly::ClipPolyhedron family, SURVEY §4 "pipeline parity tests").

This is the "CPU ref path" of BASELINE.json config 0: the device kernels are
validated against it for volumes, centroids and fragment counts. Deliberately
a *different* algorithm (vertex-adjacency surgery vs face-soup clipping) so
agreement is strong evidence of correctness.
"""

from surtr_tpu.oracle.poly import (
    Polyhedron,
    clip_polyhedron,
    cube_polyhedron,
    moments,
    polyhedron_from_mesh,
)
from surtr_tpu.oracle.voronoi import voronoi_cells_oracle

__all__ = [
    "Polyhedron",
    "clip_polyhedron",
    "cube_polyhedron",
    "moments",
    "polyhedron_from_mesh",
    "voronoi_cells_oracle",
]
