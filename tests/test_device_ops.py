"""Tests for the device tabulation engine (ops/), the sharding layer
(parallel/), and the IR utilities (ir/) -- run on the 8-device virtual
CPU mesh set up in conftest.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fiat_tpu.core import cells as cl
from fiat_tpu import elements as fe
from fiat_tpu.ops.tabulate import BatchedTabulator, ElementTabulator
from fiat_tpu.parallel.sharding import (make_interpolation_step,
                                        make_moment_step, points_mesh,
                                        shard_points, sharded_tabulate)
from fiat_tpu import ir

T = cl.ufc_simplex(2)
RNG = np.random.default_rng(7)


def test_element_tabulator_matches_host():
    el = fe.Lagrange(T, 4)
    pts = RNG.random((50, 2)) / 2
    tab = ElementTabulator(el, order=1)
    dev = tab(jnp.asarray(pts))
    host = el.tabulate(1, pts)
    for alpha in host:
        assert np.allclose(np.asarray(dev[alpha]), host[alpha],
                           atol=1e-12), alpha


def test_batched_tabulator_matches_host():
    els = [fe.Lagrange(T, p) for p in (1, 2, 3)] + \
        [fe.RaviartThomas(T, 2), fe.Nedelec(T, 1)]
    bt = BatchedTabulator(els, order=1)
    pts = RNG.random((33, 2)) / 2
    stacked = bt(jnp.asarray(pts))
    tabs = bt.unpack(stacked)
    for el, tab in zip(els, tabs):
        host = el.tabulate(1, pts)
        for alpha in host:
            assert np.allclose(np.asarray(tab[alpha]), host[alpha],
                               atol=1e-11), (el, alpha)


def test_batched_tabulator_tiling():
    """Point counts beyond the tile size concatenate correctly."""
    import fiat_tpu.ops.tabulate as mod
    els = [fe.Lagrange(T, 2)]
    bt = BatchedTabulator(els, order=0)
    pts = RNG.random((mod.DEFAULT_TILE // 512 + 7, 2)) / 2
    big = np.tile(pts, (600, 1))[: mod.DEFAULT_TILE + 13]
    stacked = bt(jnp.asarray(big))
    host = els[0].tabulate(0, big)[(0, 0)]
    dev = bt.unpack(stacked)[0][(0, 0)]
    assert np.allclose(np.asarray(dev), host, atol=1e-12)


def test_sharded_tabulate_8_devices():
    assert jax.device_count() == 8
    mesh = points_mesh()
    els = [fe.Lagrange(T, 3)]
    bt = BatchedTabulator(els, order=0)
    pts = RNG.random((64, 2)) / 2
    tables = sharded_tabulate(bt, pts, mesh)
    host = els[0].tabulate(0, pts)[(0, 0)]
    dev = bt.unpack(tables)[0][(0, 0)]
    assert np.allclose(np.asarray(dev), host, atol=1e-12)


def test_moment_step_psum():
    """Sharded moments equal the host contraction (XLA inserts the
    all-reduce over the mesh)."""
    mesh = points_mesh()
    els = [fe.Lagrange(T, 3)]
    bt = BatchedTabulator(els, order=0)
    step = make_moment_step(bt, mesh)

    npts = 80
    pts = RNG.random((npts, 2)) / 2
    w = RNG.random(npts)
    f = RNG.random(npts)
    out = np.asarray(step(shard_points(jnp.asarray(pts), mesh),
                          jnp.asarray(w), jnp.asarray(f)))
    phi = els[0].tabulate(0, pts)[(0, 0)]
    expect = phi @ (w * f)
    assert np.allclose(out, expect, atol=1e-11)


def test_interpolation_step():
    mesh = points_mesh()
    els = [fe.Lagrange(T, 2)]
    bt = BatchedTabulator(els, order=0)
    step = make_interpolation_step(bt, mesh)
    pts = RNG.random((40, 2)) / 2
    coeffs = RNG.random(els[0].space_dimension())
    out = np.asarray(step(shard_points(jnp.asarray(pts), mesh),
                          jnp.asarray(coeffs)))
    phi = els[0].tabulate(0, pts)[(0, 0)]
    assert np.allclose(out, coeffs @ phi, atol=1e-12)


def test_ir_utilities():
    def f(x):
        return jnp.sin(x) @ x

    x = jnp.ones((4, 4))
    jaxpr = ir.as_jaxpr(f, x)
    assert len(jaxpr.jaxpr.eqns) >= 2
    assert "sin" in ir.pprint(f, x)
    assert "stablehlo" in ir.lower_text(f, x) or "func" in ir.lower_text(f, x)
    cost = ir.cost_analysis(f, x)
    assert isinstance(cost, dict)
    out = ir.evaluate(f, np.ones((4, 4)))
    assert np.allclose(np.asarray(out), f(x))
    a = jnp.asarray(RNG.random((3, 4)))
    b = jnp.asarray(RNG.random((4, 5)))
    c = jnp.asarray(RNG.random((5, 2)))
    assert np.allclose(np.asarray(ir.contract("ij,jk,kl->il", a, b, c)),
                       np.asarray(a @ b @ c), atol=1e-12)


def test_batched_flop_count():
    els = [fe.Lagrange(T, 2)]
    bt = BatchedTabulator(els, order=0)
    assert bt.flop_count(1000) > 0


def test_moment_step_2d_mesh():
    """2D (points x rows) mesh: data-parallel reduction + row-sharded
    ('tensor parallel') moments match the host contraction."""
    from fiat_tpu.parallel.sharding import make_moment_step_2d, zoo_mesh
    mesh = zoo_mesh(n_points=4, n_rows=2)
    els = [fe.Lagrange(T, p) for p in (1, 2, 3)]
    bt = BatchedTabulator(els, order=0)
    step = make_moment_step_2d(bt, mesh)
    npts = 64
    pts = RNG.random((npts, 2)) / 2
    w = RNG.random(npts)
    f = RNG.random(npts)
    out = np.asarray(step(jnp.asarray(pts), jnp.asarray(w),
                          jnp.asarray(f)))[: bt.stacked.shape[0]]
    expect = np.concatenate(
        [el.tabulate(0, pts)[(0, 0)] @ (w * f) for el in els])
    assert np.allclose(out, expect, atol=1e-11)


def test_multiword_ozaki_matmul():
    """Ozaki-split bf16 matmul reaches near-f64 accuracy, ~7 bits per
    retained group order."""
    from fiat_tpu.ops.multiword import (MultiwordMatmul, matmul_f64_ozaki,
                                        prepare_B, split_scaled_host)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((200, 66)) * np.exp(
        2 * rng.standard_normal((200, 66)))
    B = rng.standard_normal((66, 3000)) * np.exp(
        2 * rng.standard_normal((66, 3000)))
    C_ref = A @ B
    scale = np.abs(C_ref).max()

    mm = MultiwordMatmul(A)
    C = np.asarray(jax.jit(mm)(jnp.asarray(B)))
    assert np.abs(C - C_ref).max() / scale < 1e-12

    # shared-B application
    slices, sA = split_scaled_host(A)
    Bp = prepare_B(jnp.asarray(B))
    C2 = np.asarray(matmul_f64_ozaki([jnp.asarray(s) for s in slices],
                                     sA, None, B_prepared=Bp))
    assert np.allclose(C2, C, atol=0)

    # accuracy improves ~7 bits per order
    errs = []
    for order in (3, 5):
        Ck = np.asarray(matmul_f64_ozaki(
            [jnp.asarray(s) for s in slices], sA, jnp.asarray(B),
            order=order))
        errs.append(np.abs(Ck - C_ref).max() / scale)
    assert errs[1] < errs[0] / 100


def test_batched_tabulator_ozaki_vs_native():
    """The Ozaki matmul engine matches the native-f64 engine to the
    framework tolerance."""
    els = [fe.Lagrange(T, p) for p in (2, 6, 10)]
    bo = BatchedTabulator(els, order=1, matmul="ozaki")
    bn = BatchedTabulator(els, order=1, matmul="native")
    pts = RNG.random((300, 2)) / 2
    to, tn = bo(pts), bn(pts)
    for alpha in tn:
        scale = max(1.0, np.abs(np.asarray(tn[alpha])).max())
        err = np.abs(np.asarray(to[alpha]) - np.asarray(tn[alpha])).max()
        assert err / scale < 1e-12, alpha


def test_tet_zoo_device_accuracy():
    """3D zoo through the device engine (f64) matches host
    tabulation within the framework tolerance."""
    T3 = cl.ufc_simplex(3)
    zoo = [fe.Lagrange(T3, p) for p in (1, 4)] + \
        [fe.RaviartThomas(T3, 2), fe.Nedelec(T3, 2)]
    bt = BatchedTabulator(zoo, order=1)
    pts = RNG.random((200, 3)) / 3
    tabs = bt.unpack(bt(jnp.asarray(pts)))
    for el, tab in zip(zoo, tabs):
        host = el.tabulate(1, pts)
        for a in host:
            err = np.abs(np.asarray(tab[a]).reshape(host[a].shape)
                         - host[a]).max()
            assert err < 1e-10, (el, a, err)


def test_macro_elements_in_batched_zoo():
    """Macro elements (HCT, Powell-Sabin) join the fused zoo via traced
    partition-of-unity side programs within the same jitted function."""
    zoo = [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3),
           fe.RaviartThomas(T, 2), fe.QuadraticPowellSabin6(T, 2)]
    bt = BatchedTabulator(zoo, order=1)
    pts = RNG.random((150, 2)) / 2
    tabs = bt.unpack(bt(jnp.asarray(pts)))
    for el, tab in zip(zoo, tabs):
        host = el.tabulate(1, pts)
        for a in host:
            err = np.abs(np.asarray(tab[a]).reshape(host[a].shape)
                         - host[a]).max()
            assert err < 1e-10, (el, a, err)


def test_moment_step_includes_macro_elements():
    """Moment/interpolation steps must cover macro side
    programs, not just the fused plain block."""
    els = [fe.Lagrange(T, 2), fe.HsiehCloughTocher(T, 3), fe.Lagrange(T, 1)]
    bt = BatchedTabulator(els, order=0)
    total_rows = max(hi for (lo, hi, shape) in bt.slices)
    assert total_rows == sum(e.space_dimension() for e in els)

    mesh = points_mesh()
    pts = RNG.random((64, 2)) / 2
    wts = RNG.random(64)
    fvals = RNG.random(64)
    step = make_moment_step(bt, mesh)
    M = np.asarray(step(jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(fvals)))
    assert M.shape == (total_rows,)
    # host oracle per element
    for el, (lo, hi, shape) in zip(els, bt.slices):
        host = el.tabulate(0, pts)[(0, 0)] @ (wts * fvals)
        assert np.allclose(M[lo:hi], host, atol=1e-11), type(el).__name__

    # transpose direction
    coeffs = RNG.random(total_rows)
    interp = make_interpolation_step(bt, mesh)
    vals = np.asarray(interp(jnp.asarray(pts), jnp.asarray(coeffs)))
    host = np.zeros(64)
    for el, (lo, hi, shape) in zip(els, bt.slices):
        host += coeffs[lo:hi] @ el.tabulate(0, pts)[(0, 0)]
    assert np.allclose(vals, host, atol=1e-11)


def test_moment_step_2d_macro():
    """Macro elements ride the 2D (points x rows) mesh: the side
    program's masked-parent stack joins the row-sharded GEMM, and the
    row-sharded moments match the host contraction."""
    from fiat_tpu.parallel.sharding import make_moment_step_2d, zoo_mesh
    els = [fe.Lagrange(T, 2), fe.HsiehCloughTocher(T, 3),
           fe.QuadraticPowellSabin6(T)]
    bt = BatchedTabulator(els, order=0)
    mesh = zoo_mesh(n_points=4, n_rows=2)
    step = make_moment_step_2d(bt, mesh)
    rng = np.random.default_rng(5)
    npts = 512
    pts = rng.random((npts, 2)) / 2
    wts = np.ones(npts) / npts
    f = rng.random(npts)
    m = np.asarray(step(jnp.asarray(pts), jnp.asarray(wts), jnp.asarray(f)))
    want = np.concatenate([
        np.asarray(el.tabulate(0, pts)[(0, 0)]).reshape(-1, npts) @ (wts * f)
        for el in els])
    rows = max(hi for _lo, hi, _s in bt.slices)
    assert np.abs(m[:rows] - want).max() < 1e-12
    assert np.abs(m[rows:]).max() == 0.0        # row padding is zero


def test_multiword_ozaki_long_contraction():
    """K > 1024 contractions must keep group-0 exactness by
    splitting the contraction axis."""
    from fiat_tpu.ops.multiword import MultiwordMatmul
    rng = np.random.default_rng(3)
    A = rng.standard_normal((16, 3000))
    B = rng.standard_normal((3000, 24))
    mm = MultiwordMatmul(A)
    C = np.asarray(mm(jnp.asarray(B)))
    rel = np.abs(C - A @ B).max() / np.abs(A @ B).max()
    assert rel < 1e-12, rel


def test_batched_ozaki_jets_path():
    """matmul='ozaki' with derivs='jets' and order>0 must run
    the multiword path (previously silently fell back to native f64)."""
    els = [fe.Lagrange(T, 3), fe.Lagrange(T, 5)]
    bt = BatchedTabulator(els, order=1, derivs="jets", matmul="ozaki")
    pts = RNG.random((40, 2)) / 2
    tabs = bt.unpack(bt(jnp.asarray(pts)))
    for el, tab in zip(els, tabs):
        host = el.tabulate(1, pts)
        for alpha in host:
            assert np.allclose(np.asarray(tab[alpha]), host[alpha],
                               atol=1e-10), alpha


def test_batched_zoo_degree0_embedding():
    """P0/DG0 embed into a higher-degree fused zoo with the correct
    scale ratio (the expansion normalisation is degree-dependent:
    1 at degree 0, sqrt(1/|K|) past it)."""
    els = [fe.P0(T), fe.DiscontinuousLagrange(T, 0), fe.Lagrange(T, 2)]
    bt = BatchedTabulator(els, order=1)
    pts = RNG.random((40, 2)) / 2
    per = bt.unpack({a: np.asarray(v) for a, v in bt(jnp.asarray(pts)).items()})
    for el, tab in zip(els, per):
        host = el.tabulate(1, pts)
        for a in host:
            assert np.allclose(np.asarray(tab[a]).reshape(host[a].shape),
                               host[a], atol=1e-10), (type(el).__name__, a)


def test_zoo_moments_match_explicit_contraction():
    """ops.moments.zoo_moments computes sum_q w_q phi_i f_q for every
    row of the zoo (macro side programs included) without building the
    nodal table; must equal the explicit table contraction."""
    from fiat_tpu.ops.moments import unpack_moments, zoo_moments
    from fiat_tpu.core.quadrature_schemes import create_quadrature
    els = [fe.Lagrange(T, 3), fe.RaviartThomas(T, 2),
           fe.HsiehCloughTocher(T, 3)]
    bt = BatchedTabulator(els, order=0)
    Q = create_quadrature(T, 8)
    pts = np.asarray(Q.get_points())
    w = np.asarray(Q.get_weights())
    f = np.cos(pts[:, 0]) * (1.0 + pts[:, 1])
    fused = np.asarray(zoo_moments(bt, pts, w, f))
    explicit = {a: np.asarray(t) for a, t in bt(jnp.asarray(pts)).items()}
    assert np.allclose(fused, explicit[(0, 0)] @ (w * f), atol=1e-12)
    per = unpack_moments(bt, fused)
    for el, m in zip(els, per):
        tab = el.tabulate(0, pts)[(0, 0)]
        want = np.tensordot(np.asarray(tab), w * f, axes=(-1, 0))
        assert np.allclose(m, want, atol=1e-12), type(el).__name__


def test_moment_rows_macro_grouping():
    """moment_rows routes macro elements through their grouped side
    programs; the result must match the per-element host contraction
    (the program row-slice bookkeeping)."""
    from fiat_tpu.ops import moments as mo
    els = [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3),
           fe.CubicHermite(T), fe.QuadraticPowellSabin6(T)]
    bt = BatchedTabulator(els, order=0)
    rng = np.random.default_rng(3)
    npts = 400
    pts = rng.random((npts, 2)) / 2
    wf = rng.random(npts)
    M = np.asarray(jax.jit(lambda q, w: mo.moment_rows(bt, q, w))(
        jnp.asarray(pts), jnp.asarray(wf)))
    per = mo.unpack_moments(bt, M)
    for el, m in zip(els, per):
        tab = np.asarray(el.tabulate(0, pts)[(0, 0)]).reshape(-1, npts)
        want = (tab @ wf).reshape(m.shape)
        assert np.abs(want - m).max() < 1e-12, type(el).__name__


def test_interpolate_rows_transpose():
    """interpolate_rows (the dual of moment_rows: coefficients ->
    field values) matches the per-element host contraction, macro
    elements included."""
    from fiat_tpu.ops import moments as mo
    els = [fe.Lagrange(T, 4), fe.HsiehCloughTocher(T, 3),
           fe.CubicHermite(T)]
    bt = BatchedTabulator(els, order=0)
    rng = np.random.default_rng(9)
    npts = 300
    pts = rng.random((npts, 2)) / 2
    rows = max(hi for _lo, hi, _s in bt.slices)
    c = rng.random(rows) - 0.5
    u = np.asarray(jax.jit(lambda q, cc: mo.interpolate_rows(bt, q, cc))(
        jnp.asarray(pts), jnp.asarray(c)))
    want = np.zeros(npts)
    for el, (lo, hi, _shape) in zip(els, bt.slices):
        tab = np.asarray(el.tabulate(0, pts)[(0, 0)]).reshape(hi - lo, npts)
        want += c[lo:hi] @ tab
    assert np.abs(u - want).max() < 1e-12

