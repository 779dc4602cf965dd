"""The one place that decides which implementation runs on which device.

Every kernel choice in the package asks ``target_is_gpu()``: a trace that
targets an NVIDIA GPU gets the hand-written GPU kernels, any other trace
(the CPU test suite, virtual CPU meshes) gets the plain XLA code. Interpret
mode is never chosen here; only tests ask for it, explicitly.
"""

from __future__ import annotations

import contextlib

import jax

_PLAIN_XLA = False


def target_is_gpu() -> bool:
    """True when the current trace targets a GPU device (and no
    ``plain_xla()`` block is active).

    ``jax.default_backend()`` ignores an active ``jax.default_device(...)``
    context (it reports the highest-priority platform), so the configured
    default device is consulted first: the sharding tests and the multi-device
    dry run trace under ``jax.default_device(cpu)``.
    """
    if _PLAIN_XLA:
        return False
    dev = jax.config.jax_default_device
    if dev is not None:
        platform = dev if isinstance(dev, str) else dev.platform
        return platform in ("gpu", "cuda")
    return jax.default_backend() == "gpu"


@contextlib.contextmanager
def plain_xla():
    """Trace the plain XLA paths even on a GPU — for timing a hand-written
    kernel against its XLA version end to end. Clears JAX's trace caches on
    entry and exit, so jitted functions retrace with the other choice."""
    global _PLAIN_XLA
    jax.clear_caches()
    _PLAIN_XLA = True
    try:
        yield
    finally:
        _PLAIN_XLA = False
        jax.clear_caches()
