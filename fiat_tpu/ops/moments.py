"""Sum-factorised moment/interpolation contractions for a fused zoo.

Integral consumers never need the nodal table:

    M[i] = sum_q w_q phi_i(x_q) f(x_q)
         = sum_k C[i, k] * (sum_q psi_k(x_q) w_q f(x_q))

contract the (small, nexp x npts) orthonormal expansion against the
points FIRST, then apply the nodal change of basis to one nexp-vector
-- 2*nexp*npts + 2*rows*nexp flops and no (rows, npts) intermediate.
Associativity here is exactly gem's sum_factorise optimisation
(/root/reference/gem/optimise.py:385) applied to the dual-evaluation
contraction (/root/reference/finat/finiteelementbase.py:245-285); the
reference performs it symbolically, this module by construction.

Both directions follow the tabulator's f64 engine: the native engine
contracts f64 tables; the emulated one ("ozaki", where its df32 path is
live) contracts df32 (hi, lo) tables and sums the products in f64.

``fiat_tpu.parallel.sharding`` shards the same contraction over a
device mesh (the point reduction becomes a psum across the devices).
"""

import jax
import jax.numpy as jnp
import numpy as np


def _df32(tabulator, points):
    """True when the tabulator's df32 pair path serves these points."""
    return tabulator._ff_ok and points.dtype == jnp.float64


def _plain_table(tabulator, points, df32):
    """The order-0 expansion table (nexp, npts): an f64 array, or a
    df32 (hi, lo) pair."""
    if df32:
        from .doublefloat import tabulate_ff
        return tabulate_ff(tabulator.target_es, tabulator.max_degree, points)
    sd = points.shape[-1]
    return tabulator._expansion_tables(points)[(0,) * sd]


def _macro_table(prog, points, df32):
    """A macro side program's masked parent stack (K, npts), as
    ``_plain_table``."""
    return prog.b_stack_ff(points, 0) if df32 else prog.b_stack(points, 0)


def _contract(table, vec, axis):
    """Contract ``table`` with ``vec`` over ``axis`` (-1: over points,
    0: over the expansion).  A df32 pair multiplies word by word; the
    products are summed in f64."""
    from .doublefloat import FF, ff_from_f64, ff_mul
    if not isinstance(table, FF):
        return table @ vec if axis == -1 else vec @ table
    v = ff_from_f64(jnp.asarray(vec, jnp.float64), xp=jnp)
    if axis == 0:
        v = FF(v.hi.reshape(-1, 1), v.lo.reshape(-1, 1))
    prod = ff_mul(table, v)
    return (jnp.sum(prod.hi.astype(jnp.float64), axis=axis)
            + jnp.sum(prod.lo.astype(jnp.float64), axis=axis))


def moment_rows(tabulator, points, wf):
    """Fused moments  M[i] = sum_q phi_i(x_q) wf_q  over every basis row
    of a BatchedTabulator's zoo (plain block + macro side programs, in
    the tabulator's row layout).  ``wf`` is the weighted integrand
    w_q * f(x_q), shape (npts,)."""
    sd = points.shape[-1]
    df32 = _df32(tabulator, points)
    stacked = jnp.asarray(tabulator.stacked, dtype=jnp.float64)
    parts = [stacked @ _contract(_plain_table(tabulator, points, df32), wf, -1)]
    # each macro side program contracts its masked parent stack once
    # against the value-alpha block of its grouped tall matrix
    macro = {}
    for prog in tabulator.macro_programs:
        bw = _contract(_macro_table(prog, points, df32), wf, -1)
        v = jnp.asarray(prog.tall[:prog.rows], jnp.float64) @ bw
        for idx, lo, hi in prog.row_slices:
            macro[idx] = v[lo:hi]
    for (i, _e), (es, deg, flat) in zip(tabulator.special,
                                        tabulator.special_progs):
        if i in macro:
            parts.append(macro[i])
        else:
            phi_s = es._tabulate(deg, points, order=0)[(0,) * sd]
            parts.append(jnp.asarray(flat, dtype=jnp.float64) @ (phi_s @ wf))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


_jitted_moment_rows = jax.jit(moment_rows, static_argnums=0)


def zoo_moments(tabulator, points, weights, f_at_pts=None):
    """Moments of a quadrature-weighted field against every basis
    function of the zoo, computed expansion-side (the nodal table is
    never built).  Returns the fused (total_rows,) vector; use
    ``unpack_moments`` for per-element views."""
    points = jnp.asarray(points)
    wf = jnp.asarray(weights)
    if f_at_pts is not None:
        wf = wf * jnp.asarray(f_at_pts)
    return _jitted_moment_rows(tabulator, points, wf)


def unpack_moments(tabulator, fused):
    """Split a fused moment vector into the per-element layout (each
    entry shaped like the element's (ndof, *value_shape))."""
    return [np.asarray(fused[lo:hi]).reshape(shape)
            for lo, hi, shape in tabulator.slices]


def interpolate_rows(tabulator, points, coefficients):
    """The transpose of ``moment_rows``: field values
    ``u(x_q) = sum_i c_i phi_i(x_q)`` at the points, for coefficients
    over every basis row of the fused zoo (macro side programs
    included) -- the reference's interpolation/point-evaluation
    direction, sum-factorised so no (rows, npts) table is built:
    fold c through the nodal change of basis first (one nexp vector),
    then evaluate against the expansion."""
    sd = points.shape[-1]
    df32 = _df32(tabulator, points)
    c = jnp.asarray(coefficients, jnp.float64)
    plain_rows = tabulator.stacked.shape[0]
    v = c[:plain_rows] @ jnp.asarray(tabulator.stacked, jnp.float64)
    out = _contract(_plain_table(tabulator, points, df32), v, 0)
    # macro side programs: gather each program's member coefficients,
    # fold them through its value-alpha block, evaluate its stack once
    grouped = {idx: (p, lo, hi) for p in tabulator.macro_programs
               for idx, lo, hi in p.row_slices}
    folded = {}
    for (i, _e), (es, deg, flat) in zip(tabulator.special,
                                        tabulator.special_progs):
        glo, ghi, _shape = tabulator.slices[i]
        if i in grouped:
            p, lo, hi = grouped[i]
            w = folded.get(id(p), jnp.zeros((p.rows,), jnp.float64))
            folded[id(p)] = w.at[lo:hi].set(c[glo:ghi])
        else:
            phi_s = es._tabulate(deg, points, order=0)[(0,) * sd]
            out = out + (c[glo:ghi] @ jnp.asarray(flat, jnp.float64)) @ phi_s
    for p in tabulator.macro_programs:
        bw = folded[id(p)] @ jnp.asarray(p.tall[:p.rows], jnp.float64)
        out = out + _contract(_macro_table(p, points, df32), bw, 0)
    return out
