"""Engine sweep: mixed element zoos through the device engine's three
operations -- tables, moments and point values -- against the host
tabulation: variants, 1D/2D/3D cells, second derivatives, macro mixes,
degree-0 members."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fiat_tpu.core.cells import ufc_simplex
from fiat_tpu import elements as fe
from fiat_tpu.ops import moments as mo
from fiat_tpu.ops.tabulate import BatchedTabulator

T1, T2, T3 = ufc_simplex(1), ufc_simplex(2), ufc_simplex(3)
RNG = np.random.default_rng(3)

CASES = {
    "1d_mix": ([lambda: fe.Lagrange(T1, 1),
                lambda: fe.GaussLobattoLegendre(T1, 4),
                lambda: fe.Legendre(T1, 3),
                lambda: fe.CubicHermite(T1)], 1),
    "gll_variant": ([lambda: fe.Lagrange(T2, 3, variant="gll"),
                     lambda: fe.Lagrange(T2, 5)], 1),
    "order2_zany": ([lambda: fe.Argyris(T2, 5), lambda: fe.Bell(T2),
                     lambda: fe.Lagrange(T2, 2)], 2),
    "tet_order2": ([lambda: fe.Lagrange(T3, 3),
                    lambda: fe.Nedelec(T3, 2)], 2),
    "macro_order2": ([lambda: fe.Lagrange(T2, 3),
                      lambda: fe.HsiehCloughTocher(T2, 3),
                      lambda: fe.QuadraticPowellSabin12(T2)], 2),
    "spectral_dg": ([lambda: fe.GaussLegendre(T2, 3),
                     lambda: fe.DiscontinuousLagrange(T2, 2)], 1),
    "degree0": ([lambda: fe.P0(T2),
                 lambda: fe.DiscontinuousLagrange(T2, 0),
                 lambda: fe.Lagrange(T2, 3)], 1),
    "hierarchical": ([lambda: fe.IntegratedLegendre(T2, 4),
                      lambda: fe.Legendre(T2, 3)], 1),
    "bdfm_mtw_tet": ([lambda: fe.BrezziDouglasFortinMarini(T3, 2),
                      lambda: fe.MardalTaiWinther(T3, 2)], 1),
    "regge_hhj": ([lambda: fe.Regge(T2, 2),
                   lambda: fe.HellanHerrmannJohnson(T2, 2)], 1),
    "order3_jets": ([lambda: fe.Lagrange(T2, 4),
                     lambda: fe.CubicHermite(T2)], 3),
}


def _host_rows(els, pts):
    """(rows, npts) host value table of a zoo in the fused row layout."""
    return np.concatenate([
        np.asarray(el.tabulate(0, pts)[(0,) * pts.shape[1]]).reshape(
            -1, len(pts)) for el in els])


def _check_tabulate(els, order, pts):
    bt = BatchedTabulator(els, order=order)
    per = bt.unpack({a: np.asarray(v) for a, v in bt(jnp.asarray(pts)).items()})
    for el, tab in zip(els, per):
        host = el.tabulate(order, pts)
        for a in host:
            assert np.allclose(np.asarray(tab[a]).reshape(np.shape(host[a])),
                               host[a], atol=1e-10), (type(el).__name__, a)


def _check_moments(els, order, pts):
    bt = BatchedTabulator(els, order=order)
    wf = RNG.random(len(pts)) - 0.5
    got = np.asarray(mo.zoo_moments(bt, pts, wf))
    want = _host_rows(els, pts) @ wf
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)


def _check_interpolate(els, order, pts):
    bt = BatchedTabulator(els, order=order)
    host = _host_rows(els, pts)
    c = RNG.random(host.shape[0]) - 0.5
    got = np.asarray(jax.jit(lambda p, cc: mo.interpolate_rows(bt, p, cc))(
        jnp.asarray(pts), jnp.asarray(c)))
    want = c @ host
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(), 1.0)


OPS = {"tabulate": _check_tabulate, "moments": _check_moments,
       "interpolate": _check_interpolate}


# the tables keep the bare case id they had before moments and point
# values joined the sweep
@pytest.mark.parametrize("case, op", [
    pytest.param(case, op, id=case if op == "tabulate" else f"{case}-{op}")
    for case in sorted(CASES) for op in sorted(OPS)])
def test_engines_match_host(case, op):
    makers, order = CASES[case]
    els = [m() for m in makers]
    sd = els[0].get_reference_element().get_spatial_dimension()
    pts = RNG.random((30, sd)) * 0.4
    OPS[op](els, order, pts)
