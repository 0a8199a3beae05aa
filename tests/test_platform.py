"""The platform decisions of the device engine: which f64 engine each
platform gets, that no path is an interpreter, f32 precision, imports
without sympy, and where the compile cache lives."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fiat_tpu import elements as fe
from fiat_tpu.core import cells as cl
from fiat_tpu.ops import F64_ENGINES, device_tabulator, f64_engine
from fiat_tpu.ops import moments as mo
from fiat_tpu.ops.tabulate import BatchedTabulator
from fiat_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = cl.ufc_simplex(2)
RNG = np.random.default_rng(31)


def _zoo():
    return [fe.Lagrange(T, 3), fe.RaviartThomas(T, 2),
            fe.HsiehCloughTocher(T, 3)]


def _primitives(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _primitives(inner)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_f64_engine_per_platform(platform):
    """Both supported platforms have f64 units and take the native
    engine; the emulated one is chosen nowhere."""
    assert f64_engine(platform) == "native"
    assert F64_ENGINES[platform] == "native"


def test_f64_engine_rejects_unknown_platform():
    with pytest.raises(NotImplementedError, match="rocm"):
        f64_engine("rocm")
    with pytest.raises(ValueError, match="matmul"):
        BatchedTabulator(_zoo(), matmul="pallas")


@pytest.mark.parametrize("f64", [True, False])
def test_device_tabulator_engine_and_dtype(f64):
    tab = device_tabulator(_zoo(), order=1, f64=f64)
    assert isinstance(tab, BatchedTabulator)
    assert tab.matmul == f64_engine()
    want = jnp.float64 if f64 else jnp.float32
    assert tab.dtype == want
    out = tab(RNG.random((20, 2)) / 2)
    assert all(t.dtype == want for t in out.values())


@pytest.mark.parametrize("order", [0, 1])
def test_device_tabulator_never_interprets(order):
    """The front door lowers to plain XLA: no pallas_call, no interpreter,
    on every path (f64 and f32, plain and macro rows)."""
    for f64 in (True, False):
        tab = device_tabulator(_zoo(), order=order, f64=f64)
        pts = jnp.zeros((40, 2), tab.dtype)
        jaxpr = jax.make_jaxpr(tab._tabulate)(pts).jaxpr
        names = {e.primitive.name for e in _primitives(jaxpr)}
        assert "pallas_call" not in names, names
        assert "dot_general" in names


@pytest.mark.parametrize("order", [0, 1])
def test_f32_dots_at_highest_precision(order):
    """Every f32 dot of the f32 engine (the change of basis, plain and
    macro rows) asks for HIGHEST precision, so a GPU does not run it in
    TF32 (~1e-3 relative)."""
    tab = device_tabulator(_zoo(), order=order, f64=False)
    jaxpr = jax.make_jaxpr(tab._tabulate)(jnp.zeros((40, 2), jnp.float32))
    dots = [e for e in _primitives(jaxpr.jaxpr)
            if e.primitive.name == "dot_general"
            and e.outvars[0].aval.dtype == jnp.float32]
    assert len(dots) >= 2
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def test_f32_tables_match_host():
    """f32 tables against the host f64 tables, relative to each table's
    largest entry, within the chip smoke test's f32 bound."""
    import chip_smoke
    zoo = _zoo()
    pts = RNG.random((200, 2)) / 2
    tab = device_tabulator(zoo, order=1, f64=False)
    per = tab.unpack({a: np.asarray(t) for a, t in tab(pts).items()})
    err = chip_smoke.table_error(per, zoo, pts, 1, relative=True)
    assert 0 < err < chip_smoke.F32_RTOL


def test_masks_follow_engine_decision(monkeypatch):
    """The df32 binning of macro subcells is taken only where the
    platform's engine is the emulated one."""
    from fiat_tpu.core.expansions import partition_of_unity_masks
    from fiat_tpu.ops import doublefloat

    def refuse(*args, **kwargs):
        raise AssertionError("df32 distance on a native-f64 platform")
    monkeypatch.setattr(doublefloat, "ff_l1_distance", refuse)
    hct = fe.HsiehCloughTocher(T, 3)
    pts = jnp.asarray(RNG.random((30, 2)) / 2)
    masks = partition_of_unity_masks(
        hct.get_nodal_basis().get_expansion_set().ref_el, pts)
    assert np.allclose(sum(np.asarray(m) for m in masks), 1.0)


@pytest.mark.parametrize("op", ["moments", "interpolate"])
def test_df32_pair_path_plumbing(op):
    """The emulated engine's df32 pair path for moments and point values
    runs and agrees with the host.  XLA:CPU contracts the error-free
    transforms into FMAs, so only f32-level accuracy holds here; the
    engine decision never takes this path on the CPU."""
    zoo = _zoo()
    bt = BatchedTabulator(zoo, order=0, matmul="ozaki")
    bt._ff_ok = True
    pts = RNG.random((150, 2)) / 2
    host = np.concatenate([
        np.asarray(el.tabulate(0, pts)[(0, 0)]).reshape(-1, len(pts))
        for el in zoo])
    if op == "moments":
        wf = RNG.random(len(pts))
        got, want = np.asarray(mo.zoo_moments(bt, pts, wf)), host @ wf
    else:
        c = RNG.random(host.shape[0]) - 0.5
        got = np.asarray(jax.jit(lambda p, cc: mo.interpolate_rows(bt, p, cc))(
            jnp.asarray(pts), jnp.asarray(c)))
        want = c @ host
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_import_without_sympy():
    """The package and the main path need only jax, numpy and scipy; an
    element built in sympy raises ImportError when it is constructed."""
    code = "\n".join([
        "import sys",
        "sys.modules['sympy'] = None",
        "import numpy as np",
        "import fiat_tpu, fiat_tpu.ops",
        "from fiat_tpu.core.cells import UFCQuadrilateral, ufc_simplex",
        "from fiat_tpu.elements import Lagrange, TrimmedSerendipityEdge",
        "from fiat_tpu.ops import device_tabulator",
        "from fiat_tpu.ops.moments import zoo_moments",
        "tab = device_tabulator([Lagrange(ufc_simplex(2), 2)], order=1)",
        "pts = np.full((4, 2), 0.25)",
        "assert tab(pts)[(0, 0)].shape == (6, 4)",
        "assert zoo_moments(tab, pts, np.ones(4)).shape == (6,)",
        "try:",
        "    TrimmedSerendipityEdge(UFCQuadrilateral(), 2)",
        "except ImportError:",
        "    print('sympy-free')",
    ])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "sympy-free"


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_and_ignored(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives in one fixed
    directory of the checkout, which git ignores."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compilation_cache_dir()
    assert path == runtime.DEFAULT_CACHE_DIR
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert os.path.basename(path) + "/" in ignored
