"""Platform decisions kept in one place: the compile-cache location, build
defaults that do not depend on the backend, the pinned matrix-product
precision, and a main path that needs no optional package."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from pyspeedy_tpu import example_bc_file
from pyspeedy_tpu.models import model as M
from pyspeedy_tpu.ops import spectral as S
from pyspeedy_tpu.params import T30L8
from pyspeedy_tpu.utils.compile_cache import enable_compile_cache
from pyspeedy_tpu.utils.dataset import open_dataset

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; otherwise the
    cache goes to the fixed <checkout>/.jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert ("jax_compilation_cache_dir", path) in calls


def test_build_consts_defaults_ignore_backend(monkeypatch):
    params = dataclasses.replace(T30L8, fft_mode="matmul")
    flags = {}
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        consts, _ = M.build_consts(params)
        flags[backend] = {
            f.name: getattr(consts, f.name)
            for f in dataclasses.fields(consts)
            if isinstance(getattr(consts, f.name), (bool, int))}
        flags[backend]["use_dense_legendre"] = consts.sp.use_dense_legendre
    assert flags["cpu"] == flags["gpu"] == flags["rocm"]
    assert not flags["gpu"]["grid_phi"]
    assert not flags["gpu"]["bf16_tendencies"]


def _dot_precisions(jaxpr):
    """precision of every dot_general in a jaxpr, nested jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            sub = getattr(p, "jaxpr", p)
            if hasattr(sub, "eqns"):
                out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("fft_mode", ["matmul", "fft"])
def test_transform_pair_pins_matmul_precision(fft_mode):
    params = dataclasses.replace(T30L8, precision="f32", fft_mode=fft_mode)
    consts, _ = M.build_consts_cached(params)
    sp = consts.sp
    grid = jnp.zeros((params.kx, params.il, params.ix), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda g: S.spec2grid_p(sp, S.grid2spec_p(sp, g)))(grid)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions, "no matrix product in the transform pair"
    pinned = (S.MATMUL_PRECISION, S.MATMUL_PRECISION)
    assert all(p == pinned for p in precisions), precisions


def test_bundled_bc_opens_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now fails
    ds = open_dataset(example_bc_file())
    for name in ("orog", "lsm", "alb", "vegh", "vegl", "stl", "snowd",
                 "swl1", "swl2", "swl3", "sst", "icec"):
        assert ds[name].dims[:2] == ("lon", "lat"), name
    assert ds["sst"].shape == (96, 48, 12)


def test_netcdf4_without_h5py_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = tmp_path / "user_file.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(ImportError, match="h5py"):
        open_dataset(str(path))
