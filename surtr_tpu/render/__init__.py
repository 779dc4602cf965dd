"""On-device software rasterizer — the replacement for the reference's D3D12
two-pass pipeline (shadow depth + opaque, SURVEY §1 L5''): step + render stay
on the device, no host round-trip."""

from surtr_tpu.render.raster import render_scene

__all__ = ["render_scene"]
