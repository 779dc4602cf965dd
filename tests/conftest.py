"""Test configuration: force the CPU backend with 8 virtual devices.

Must run before jax initializes a backend (SURVEY.md §4 "fake/offline
backends": multi-chip sharding is tested on a virtual CPU mesh). The tests
never open a GPU, even on a machine that has one: every xdist worker runs
this file first. ``jax.config.update`` wins over the environment as long as
no backend is initialized yet; the env vars are set too, for subprocesses.
"""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
try:
    jax.config.update("jax_platforms", "cpu")
    if "xla_force_host_platform_device_count" not in flags:
        jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # backend already up (e.g. conftest re-imported) — keep what exists

assert jax.default_backend() == "cpu", (
    "tests must run on the CPU backend; got " + jax.default_backend()
)
assert len(jax.devices()) >= 8, (
    f"tests need 8 virtual CPU devices, got {len(jax.devices())}"
)

# Persistent compile cache: the suite is compile-dominated (each fracture /
# physics config is a fresh jit, ~30-90 s each on CPU). Warm runs drop from
# ~13 min to a few minutes. Keyed by HLO hash — safe across code changes —
# but NOT by host CPU: XLA:CPU caches AOT machine code, and an entry written
# on a different host loads here with a feature-set mismatch warning
# ("could lead to SIGILL") and subtly different vectorization, which flips
# fp-tie-sensitive parity tests (measured: the Pallas-vs-XLA narrowphase
# trajectory test diverged ONLY when executing foreign cache entries). Salt
# the cache path with a CPU-feature fingerprint so each host compiles its
# own binaries.
import hashlib

from surtr_tpu.compile_cache import enable_compile_cache

try:
    _cpu = next(l for l in open("/proc/cpuinfo") if l.startswith("flags"))
except Exception:
    import platform

    _cpu = platform.processor() or "unknown"
_tag = hashlib.md5(_cpu.encode()).hexdigest()[:8]
enable_compile_cache("cpu-" + _tag)

# The image's zstandard C backend segfaults intermittently inside
# ZstdCompressor/Decompressor under heavy parallel compile load (observed
# twice in full-suite runs, both stacks ending in compilation_cache
# put/get_executable_and_time -> zstandard.backend_c). Force JAX's zlib
# fallback — entries are small CPU executables, the compressor choice is
# immaterial — and note the cache dir above is fresh per CPU fingerprint,
# so no zstd-compressed entries linger once this landed.
from jax._src import compilation_cache as _cc

_cc.zstandard = None


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_per_module():
    """Free compiled executables at module boundaries. Round 4's model-scale
    compiles (exact caps, pumpkin/bunny prepare) push the in-process
    XLA:CPU JIT over some internal limit: four full-suite runs segfaulted
    compiling test_scene's render program (backend_compile_and_load — the
    persistent cache was ruled out by nulling the cache dir), while every
    module passes standalone. Dropping executables between modules keeps
    the process under the threshold; the on-disk compile cache makes the
    few cross-module recompiles cheap."""
    yield
    import jax

    jax.clear_caches()
