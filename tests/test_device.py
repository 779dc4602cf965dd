"""The device-dispatch point, the compile-cache rule, and matmul precision
on the traced main path."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import surtr_tpu.ops.clip_pallas as clip_pallas
import surtr_tpu.render.raster as raster
from surtr_tpu.device import plain_xla, target_is_gpu
from surtr_tpu.types import unit_cube

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (scan, cond, pjit, ...) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub)


def _prims(fn, *args):
    jax.clear_caches()  # jitted callees retrace with the current dispatch
    return [e for e in _eqns(jax.make_jaxpr(fn)(*args).jaxpr)]


def _fold_args(N=3, K=5):
    poly = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), unit_cube()
    )
    n = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, -0.2]]), (N, K, 1))
    return poly, n, jnp.ones((N, K), bool)


def _screen_args(T=20):
    rng = np.random.default_rng(0)
    return (
        jnp.asarray(rng.uniform(0, 32, (T, 3)), jnp.float32),
        jnp.asarray(rng.uniform(0, 32, (T, 3)), jnp.float32),
        jnp.asarray(rng.uniform(0.1, 0.9, (T, 3)), jnp.float32),
        jnp.ones((T,), bool),
    )


def test_cpu_trace_does_not_target_the_gpu():
    assert not target_is_gpu()
    with jax.default_device(jax.devices("cpu")[0]):
        assert not target_is_gpu()
    with plain_xla():
        assert not target_is_gpu()


def test_cpu_traces_pick_xla_paths():
    """On the CPU the fold and the raster trace their XLA versions: no
    pallas_call at all (so no interpret mode either)."""
    fold = _prims(clip_pallas.clip_planes_batch, *_fold_args())
    ras = _prims(lambda *a: raster.raster_screen(*a, 32, 32), *_screen_args())
    for eqns in (fold, ras):
        assert not [e for e in eqns if e.primitive.name == "pallas_call"]


def test_gpu_traces_pick_compiled_kernels(monkeypatch):
    """With the dispatch point answering "GPU", both sites trace their
    Pallas kernel on the Triton route, compiled (interpret=False)."""
    monkeypatch.setattr(clip_pallas, "target_is_gpu", lambda: True)
    monkeypatch.setattr(raster, "target_is_gpu", lambda: True)
    fold = _prims(clip_pallas.clip_planes_batch, *_fold_args())
    ras = _prims(lambda *a: raster.raster_screen(*a, 32, 32), *_screen_args())
    for eqns in (fold, ras):
        calls = [e for e in eqns if e.primitive.name == "pallas_call"]
        assert len(calls) == 1
        assert not calls[0].params["interpret"]
        assert "triton" in calls[0].params["compiler_params"]


def test_fold_dispatch_falls_back_for_non_pow2_slots(monkeypatch):
    """The kernel needs a power-of-two face-loop width; other widths keep
    the XLA fold even on a GPU."""
    monkeypatch.setattr(clip_pallas, "target_is_gpu", lambda: True)
    _, planes, mask = _fold_args()
    odd = unit_cube(S=12)
    odd = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (3,) + a.shape), odd
    )
    eqns = _prims(clip_pallas.clip_planes_batch, odd, planes, mask)
    assert not [e for e in eqns if e.primitive.name == "pallas_call"]


def _cache_dir(env_value, cwd):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax; from surtr_tpu.compile_cache import enable_compile_cache;"
        "p = enable_compile_cache();"
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env | {"PYTHONPATH": ROOT},
        capture_output=True, text=True, check=True, timeout=120,
    )
    return out.stdout.split()


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_rule(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set (and nothing overrides it);
    otherwise <checkout>/.jax_cache, whatever the working directory."""
    env_value = str(tmp_path / "elsewhere-cache") if env_set else None
    returned, configured = _cache_dir(env_value, tmp_path)
    want = env_value or os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want


def _f32_dots_not_highest(fn, *args):
    with jax.default_matmul_precision(None):
        eqns = _prims(fn, *args)
    bad = []
    for e in eqns:
        if e.primitive.name != "dot_general":
            continue
        if not any(v.aval.dtype == jnp.float32 for v in e.invars):
            continue
        prec = e.params["precision"]
        if prec is None or any(
            p != jax.lax.Precision.HIGHEST for p in prec
        ):
            bad.append(str(e.source_info.traceback).splitlines()[-1:])
    return bad


def test_main_path_f32_dots_are_highest():
    """An f32 matrix product may run in TF32 on a GPU: every f32 dot_general
    traced on the main path (prepare, impact, the fused frame with its
    physics step and render) must pin HIGHEST precision."""
    from surtr_tpu.config import (
        FractureConfig, PhysicsConfig, RenderConfig, SceneConfig,
    )
    from surtr_tpu.fracture.pipeline import prepare_fracture
    from surtr_tpu.io.models import get_model, sphere_point_cloud
    from surtr_tpu.scene import Scene, interactive_frame

    cfg = SceneConfig(
        fracture=FractureConfig(
            initial_decompose_cell_cnt=8, max_pieces=32, max_active_pieces=8,
            max_piece_tris=32, partial_pattern_cell_cnt=8,
            general_pattern_cell_cnt=8, voronoi_neighbors=7,
        ),
        physics=PhysicsConfig(broadphase_block=32, max_hull_verts=16),
        render=RenderConfig(width=32, height=32, shadow_size=32),
    )
    v, f = get_model("cube")
    fc = cfg.fracture
    bad = _f32_dots_not_highest(
        lambda k: prepare_fracture(
            jnp.asarray(v), jnp.ones(len(v), bool), jnp.asarray(v[f]),
            jnp.ones(len(f), bool), jnp.asarray(sphere_point_cloud()), k, fc,
        ),
        jax.random.PRNGKey(0),
    )
    sc = Scene("cube", cfg)
    bad += _f32_dots_not_highest(
        lambda p, ph, x0: interactive_frame(
            p, ph, x0, sc.ctx, jnp.asarray([0.0, 10.0, 0.0]),
            jnp.asarray([0.0, -1.0, 0.0]), jnp.asarray([8.0, 6.0, 8.0]),
            jnp.asarray([0.0, 1.0, 0.0]), cfg=sc.cfg,
        ),
        sc.pieces, sc.phys, sc._x0,
    )
    assert not bad, bad
