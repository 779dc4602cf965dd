"""Geometry kernels (pure, renderer-free) — this framework's analogue of the
reference's L4 layer (VMACH / Poly / Kdop / DT3D, SURVEY.md §1)."""
