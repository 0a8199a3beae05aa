"""Multi-device scaling for batched tabulation.

The reference is a single-process numpy library (SURVEY.md §2.5); the
natural parallel axis of this workload is the POINT batch (tabulation
is embarrassingly parallel over points, while moment/dual contractions
reduce over points and need an all-reduce).  This module provides:

* ``points_mesh(n)``        -- a 1D device mesh over a "points" axis;
* ``shard_points(x, mesh)`` -- place a point batch with the leading axis
  sharded across the mesh;
* ``sharded_tabulate``      -- run any jitted tabulator SPMD over the mesh
  (no communication: outputs stay point-sharded);
* ``make_moment_step``      -- integral moments  M[i] = sum_q w_q phi_i(x_q)
  f(x_q) over a sharded point batch: each device contracts its local shard
  and XLA inserts a psum over the mesh;
* ``make_interpolation_step`` -- the transpose (point values), sharded;
* ``make_moment_step_2d``   -- moments on a (points x rows) mesh.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def points_mesh(n_devices=None, devices=None, axis="points"):
    """A 1D mesh over the point-batch axis."""
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_points(points, mesh, axis="points"):
    """Device-put a (npts, sd) batch sharded along the leading axis."""
    return jax.device_put(points, NamedSharding(mesh, P(axis, None)))


def sharded_tabulate(tabulator, points, mesh, axis="points"):
    """Tabulate with the point axis sharded: pure SPMD, no collectives.
    Tables come back sharded on their trailing (point) axis."""
    points = shard_points(jnp.asarray(points), mesh, axis)
    return tabulator(points)


# the sum-factorised contractions of the single-device consumer API
# (contract the small expansion table against the points FIRST; under
# sharding the inner reduction is what psums over the mesh)
from ..ops.moments import interpolate_rows as _interpolate_rows  # noqa: E402
from ..ops.moments import moment_rows as _moment_rows  # noqa: E402


def make_moment_step(tabulator, mesh, axis="points"):
    """A jitted 'assembly step': given sharded points, weights, and a field
    f at the points, compute all moments  M[i] = sum_q w_q phi_i(x_q) f(x_q)
    for every basis function of the fused zoo (macro elements included via
    their side programs).  The contraction reduces over the sharded axis,
    so XLA emits an all-reduce (psum) across the mesh."""
    pspec = NamedSharding(mesh, P(axis, None))
    wspec = NamedSharding(mesh, P(axis))

    @partial(jax.jit,
             in_shardings=(pspec, wspec, wspec),
             out_shardings=NamedSharding(mesh, P()))
    def step(points, weights, f_at_pts):
        return _moment_rows(tabulator, points, weights * f_at_pts)
    return step


def zoo_mesh(n_points=None, n_rows=None, devices=None,
             axes=("points", "rows")):
    """A 2D mesh: the point batch ('data parallel') axis times the
    basis-row ('tensor parallel') axis of the stacked zoo."""
    if devices is None:
        devices = jax.devices()
    if n_points is None or n_rows is None:
        n = len(devices)
        n_rows = n_rows or 1
        n_points = n_points or n // n_rows
    devices = np.asarray(devices[: n_points * n_rows]).reshape(
        n_points, n_rows)
    return Mesh(devices, axes)


def make_moment_step_2d(tabulator, mesh, axes=("points", "rows")):
    """Moments on a 2D (points x rows) mesh: the expansion-vs-points
    contraction reduces over the sharded point axis (psum along
    'points'); the nodal matrix is sharded over its row axis so each
    device owns a slice of the moments ('tensor parallel' output).

    Macro elements ride the SAME row-sharded GEMM: each side program's
    masked-parent stack contributes extra columns to one block matrix
    whose rows are the fused zoo layout (plain block first, then the
    specials' global row ranges), so the tensor-parallel axis covers
    the whole zoo -- not just the plain block."""
    paxis, raxis = axes
    pspec = NamedSharding(mesh, P(paxis, None))
    wspec = NamedSharding(mesh, P(paxis))
    out_spec = NamedSharding(mesh, P(raxis))

    progs = list(getattr(tabulator, "macro_programs", None) or ())
    if tabulator.special_progs and not progs:
        raise NotImplementedError(
            "make_moment_step_2d needs the grouped macro side programs "
            "for its row-sharded GEMM; this tabulator's special elements "
            "lack them (use make_moment_step)")

    # one block row-matrix over [expansion | program stacks] columns,
    # rows in the fused layout; zero-padded to a multiple of the
    # row-axis size so the output shards evenly (the step returns the
    # padded moments -- entries beyond the fused rows are zero)
    nexp = tabulator.stacked.shape[1]
    rows = max(hi for _lo, hi, _shape in tabulator.slices)
    width = nexp + sum(p.K for p in progs)
    nr = mesh.shape[raxis]
    padded_rows = -(-rows // nr) * nr
    A = np.zeros((padded_rows, width))
    A[:tabulator.stacked.shape[0], :nexp] = tabulator.stacked
    col = nexp
    for p in progs:
        val = p.tall[:p.rows]                   # the value-alpha block
        for idx, lo, hi in p.row_slices:
            glo, ghi, _shape = tabulator.slices[idx]
            A[glo:ghi, col:col + p.K] = val[lo:hi]
        col += p.K

    @partial(jax.jit, in_shardings=(pspec, wspec, wspec),
             out_shardings=out_spec)
    def step(points, weights, f_at_pts):
        base = tabulator._expansion_tables(points)
        sd = points.shape[-1]
        phi = base[(0,) * sd]                   # (nexp, npts)
        wfv = weights * f_at_pts
        vecs = [phi @ wfv]                      # psum over 'points'
        for p in progs:
            vecs.append(p.b_stack(points, 0) @ wfv)
        vec = jnp.concatenate(vecs) if len(vecs) > 1 else vecs[0]
        blocks = jax.lax.with_sharding_constraint(
            jnp.asarray(A, dtype=points.dtype),
            NamedSharding(mesh, P(raxis, None)))
        return blocks @ vec                     # row-sharded moments
    return step


def make_interpolation_step(tabulator, mesh, axis="points"):
    """The transpose direction: given coefficients per basis row of the
    fused zoo (macro side programs included), evaluate the field at a
    sharded point batch (no communication; the result stays
    point-sharded)."""
    pspec = NamedSharding(mesh, P(axis, None))

    @partial(jax.jit, in_shardings=(pspec, None),
             out_shardings=NamedSharding(mesh, P(axis)))
    def step(points, coefficients):
        return _interpolate_rows(tabulator, points, coefficients)
    return step
