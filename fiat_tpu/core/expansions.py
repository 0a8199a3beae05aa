"""Orthogonal (Dubiner) expansion bases on simplices, TPU-native.

Behavioural parity with /root/reference/FIAT/expansions.py (Kirby 2010
singularity-free recurrence; Karniadakis & Sherwin collapsed coordinates),
redesigned for JAX:

* the *value* recurrence is written once over generic array arithmetic, so
  it runs vectorised in numpy on host (construction paths) and traces under
  ``jax.jit``/``vmap`` on device;
* ALL derivative orders come from forward-mode AD (nested ``jax.jvp``)
  instead of the reference's hand-written order<=2 recurrence plus
  dmats-chain fallback (expansions.py:329-366) -- exact, any order, and
  XLA-fusable;
* tabulations over many points are whole-batch array programs (points are a
  trailing batch axis), never per-point Python loops.
"""

import math
from functools import lru_cache
from itertools import chain

import numpy as np
import jax
import jax.numpy as jnp

from . import cells as cl
from ..utils.jets import (Jet, concat_rows, matapply, multiindices,
                          take_rows, taylor_seeds)


def _is_traced(x):
    return isinstance(x, (jax.core.Tracer, jax.Array)) and not isinstance(x, np.ndarray)


def _stack_rows(rows, npts, traced):
    """Stack per-member rows (arrays / scalars / None) to (m, npts)."""
    xp = jnp if traced or any(_is_traced(r) for r in rows) else np
    out = []
    for r in rows:
        if r is None:
            out.append(xp.zeros(npts))
        elif hasattr(r, "shape") and r.shape != ():
            out.append(r)
        else:
            out.append(xp.broadcast_to(xp.asarray(r, dtype=xp.float64), (npts,))
                       if xp is jnp else np.broadcast_to(np.float64(r), (npts,)))
    return xp.stack(out)

# ---------------------------------------------------------------------------
# Multi-index orderings (shared with the reference's morton convention)

def morton_index2(p, q=0):
    return (p + q) * (p + q + 1) // 2 + q


def morton_index3(p, q=0, r=0):
    return ((p + q + r) * (p + q + r + 1) * (p + q + r + 2) // 6
            + (q + r) * (q + r + 1) // 2 + r)


def _morton(dim):
    return (lambda p: p, morton_index2, morton_index3)[dim - 1]


def jacobi_recurrence_coeffs(a, b, n):
    """(a_n, b_n, c_n) of the three-term Jacobi recurrence (python floats)."""
    an = (2 * n + 1 + a + b) * (2 * n + 2 + a + b) / (2 * (n + 1) * (n + 1 + a + b))
    bn = (a + b) * (a - b) * (2 * n + 1 + a + b) / (2 * (n + 1) * (n + 1 + a + b) * (2 * n + a + b))
    cn = (n + a) * (n + b) * (2 * n + 2 + a + b) / ((n + 1) * (n + 1 + a + b) * (2 * n + a + b))
    return an, bn, cn


def integrated_jacobi_recurrence_coeffs(a, b, n):
    if n == 1:
        return (a + b + 2) / 2, (a - 3 * b - 2) / 2, 0.0
    return jacobi_recurrence_coeffs(a - 1, b + 1, n - 1)


# ---------------------------------------------------------------------------
# Member-vectorized recurrence (the TPU formulation)
#
# The reference evaluates the Kirby recurrence one basis member at a time
# (an O(n^dim)-operation program).  Here each degree step advances ALL
# members that share a trailing index simultaneously: the working state is a
# stacked (num_rows, npts) array and the Jacobi coefficients become static
# per-row column vectors.  The whole tabulation is O(n * dim) large array
# operations -- small XLA graphs (fast compiles), bounded live memory, and
# whole-batch elementwise work.  Derivatives come from running the same
# program on Taylor jets whose components are the stacked arrays.

def _stage_multiindices(length, n, dim):
    """Multi-indices of the given length with sum <= n, ordered by the
    dim-variable morton rank (trailing zeros implied)."""
    idx = _morton(dim)
    mis_ = [mi for mi in multiindices(length, n)]
    return sorted(mis_, key=lambda mi: idx(*mi, *((0,) * (dim - length))))


def _variant_alpha(sub, variant):
    if variant == "bubble":
        return 2 * sum(sub)
    alpha = 2 * sum(sub) + len(sub)
    if variant == "dual":
        alpha += 1 + len(sub)
    return alpha


@lru_cache(maxsize=None)
def _stage_constants(dim, n, codim, variant):
    """Static per-row recurrence data for one codimension stage:
    (a1, b1) first-step vectors, {i: (a, b, c)} general-step vectors, the
    gather permutation into the next stage's morton order, and the
    normalization vector of the next stage."""
    beta = 1 if variant == "dual" else 0
    coeff_fn = (integrated_jacobi_recurrence_coeffs if variant == "bubble"
                else jacobi_recurrence_coeffs)
    subs = _stage_multiindices(codim, n, dim)
    m_in = len(subs)
    alphas = np.array([_variant_alpha(sub, variant) for sub in subs], dtype=np.float64)

    if variant == "bubble":
        a1 = np.full((m_in, 1), -0.5)
        b1 = np.full((m_in, 1), -0.5)
    else:
        a1 = (0.5 * (alphas + beta) + 1.0).reshape(-1, 1)
        b1 = (0.5 * (alphas - beta)).reshape(-1, 1)

    # step i produces trailing-index-i members from i-1 and i-2, which is the
    # three-term recurrence evaluated at index i-1.
    general = {}
    for i in range(2, n + 1):
        abc = np.array([coeff_fn(al, beta, i - 1) for al in alphas])
        general[i] = (abc[:, 0:1], abc[:, 1:2], abc[:, 2:3])

    # gather permutation: next-stage multiindices -> (i * m_in + row_in)
    outs = _stage_multiindices(codim + 1, n, dim)
    sub_rank = {sub: r for r, sub in enumerate(subs)}
    perm = np.array([mi[-1] * m_in + sub_rank[mi[:-1]] for mi in outs], dtype=int)

    # normalization of the next stage (d = codim + 1)
    d = codim + 1
    shift = 1 if variant == "dual" else 0
    norms = []
    for mi in outs:
        if variant is not None:
            p = mi[-1] + shift
            al = 2 * (sum(mi[:-1]) + d * shift) - 1
            norm2 = (0.5 + d) / d
            if p > 0 and p + al > 0:
                norm2 *= (p + al) * (2 * p + al) / p
        else:
            norm2 = (2 * sum(mi) + d) / d
        norms.append(math.sqrt(norm2))
    norms = np.asarray(norms).reshape(-1, 1)
    return a1, b1, general, perm, norms


@lru_cache(maxsize=None)
def _c0_matrix(dim, n):
    """Static matrix C with phi_C0 = C @ phi_bubble (facet-bubble recovery
    differencing + entity reordering), derived by running the index algebra
    on identity rows."""
    m = math.comb(n + dim, dim)
    rows = c0_reorder(dim, n, [row for row in np.eye(m)])
    return np.stack(rows)


def dubiner_tabulate(dim, n, coords, scale, variant=None, xp=np):
    """Stacked tabulation (num_members, npts) of the Dubiner basis at points
    on the default (-1,1) simplex.

    :arg coords: list of ``dim`` coordinate objects -- (npts,) arrays (plain
        values) or Jets over them (values + derivatives).
    :returns: a (num_members, npts) array, or a Jet whose components are
        such arrays.
    """
    if variant not in (None, "bubble", "dual"):
        raise ValueError(f"Invalid expansion variant {variant!r}")
    if dim > 3:
        raise ValueError("Only dim <= 3 simplices supported")
    eff_scale = -scale if variant == "bubble" else scale

    x0 = coords[0]
    if isinstance(x0, Jet):
        npts_val = next(iter(x0.comps.values()))
        ones = xp.zeros(npts_val.shape)[None] + 1.0
        R = Jet(x0.nvars, x0.order, {(0,) * x0.nvars: ones * eff_scale})
    else:
        R = (xp.zeros(x0.shape) + eff_scale)[None]

    if n == 0:
        out = R
    else:
        X = tuple(coords) + (-1.0, -1.0)
        for codim in range(dim):
            x, y, z = X[codim], X[codim + 1], X[codim + 2]
            fb = 0.5 * (y + z)
            fa = x + fb + 1.0
            fc = fb * fb
            a1, b1, general, perm, norms = _stage_constants(dim, n, codim, variant)
            levels = [R]
            if n >= 1:
                levels.append((a1 * fa - b1 * fb) * R)
            for i in range(2, n + 1):
                a, b, c = general[i]
                levels.append((a * fa - b * fb) * levels[-1]
                              - (c * fc) * levels[-2])
            big = concat_rows(levels, xp)
            R = take_rows(big, perm) * norms
        out = R

    if variant == "bubble":
        out = matapply(_c0_matrix(dim, n), out)
    return out


def c0_reorder(dim, n, phi):
    """Turn a 'bubble' (integrated-Jacobi) tabulation into the C0 hierarchy:
    recover facet bubbles by differencing, then renumber vertex/edge/face/
    interior blocks in reference order.  Purely index algebra on the member
    list; works for numpy and traced arrays."""
    idx = _morton(dim)
    phi = list(phi)
    phi[0] = -phi[0]
    for i in range(1, dim + 1):
        phi[0] = phi[0] - phi[i]
    if dim == 2:
        for i in range(2, n + 1):
            phi[idx(0, i)] = phi[idx(0, i)] - phi[idx(1, i - 1)]
    elif dim == 3:
        for i in range(2, n + 1):
            for j in range(0, n + 1 - i):
                phi[idx(0, i, j)] = phi[idx(0, i, j)] - phi[idx(1, i - 1, j)]
            icur = idx(0, 0, i)
            phi[icur] = phi[icur] - phi[idx(0, 1, i - 1)]
            phi[icur] = phi[icur] - phi[idx(1, 0, i - 1)]

    order = list(range(dim + 1))
    if dim == 1:
        order.extend(range(2, n + 1))
    elif dim == 2:
        order.extend(idx(1, i - 1) for i in range(2, n + 1))
        order.extend(idx(0, i) for i in range(2, n + 1))
        order.extend(idx(i, 0) for i in range(2, n + 1))
        order.extend(idx(i, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
    elif dim == 3:
        order.extend(idx(0, 1, i - 1) for i in range(2, n + 1))
        order.extend(idx(1, 0, i - 1) for i in range(2, n + 1))
        order.extend(idx(1, i - 1, 0) for i in range(2, n + 1))
        order.extend(idx(0, 0, i) for i in range(2, n + 1))
        order.extend(idx(0, i, 0) for i in range(2, n + 1))
        order.extend(idx(i, 0, 0) for i in range(2, n + 1))
        order.extend(idx(1, i - 1, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(0, i, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, 0, j) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, j, 0) for j in range(1, n + 1) for i in range(2, n - j + 1))
        order.extend(idx(i, j, k) for k in range(1, n + 1)
                     for j in range(1, n - k + 1) for i in range(2, n - j - k + 1))
    return [phi[i] for i in order]


def mis(m, n):
    """All m-tuples of nonnegative integers summing to n (reference order)."""
    if m == 1:
        return [(n,)]
    if n == 0:
        return [(0,) * m]
    return [(n - i,) + rest for i in range(n + 1) for rest in mis(m - 1, i)]


# ---------------------------------------------------------------------------
# Expansion sets

class ExpansionSet:
    """Dubiner expansion set over a simplicial complex.

    Tabulations run through a single generic recurrence: numpy-evaluated on
    host for order-0 construction paths, JAX-evaluated (eager or jitted)
    whenever derivatives are requested or tracing is active.
    """

    def __new__(cls, *args, **kwargs):
        if cls is not ExpansionSet:
            return super().__new__(cls)
        ref_el = args[0]
        table = {cl.POINT: PointExpansionSet,
                 cl.LINE: LineExpansionSet,
                 cl.TRIANGLE: TriangleExpansionSet,
                 cl.TETRAHEDRON: TetrahedronExpansionSet}
        try:
            sub = table[ref_el.get_shape()]
        except KeyError:
            raise ValueError("Invalid reference element type.")
        return sub(*args, **kwargs)

    def __init__(self, ref_el, scale=None, variant=None):
        self.ref_el = ref_el
        self.variant = variant
        space_dim = ref_el.get_spatial_dimension()
        top = ref_el.get_topology()
        base = cl.default_simplex(space_dim)
        base_verts = base.get_vertices()
        self.affine_mappings = [
            cl.make_affine_mapping(ref_el.get_vertices_of_subcomplex(top[space_dim][cell]),
                                   base_verts)
            for cell in top[space_dim]]
        if scale is None:
            scale = math.sqrt(1.0 / base.volume())
        self.scale = scale
        self.continuity = "C0" if variant == "bubble" else None
        self.recurrence_order = 2
        self._dmats_cache = {}
        self._cell_node_map_cache = {}

    def reconstruct(self, ref_el=None, scale=None, variant=None):
        return ExpansionSet(ref_el or self.ref_el,
                            scale=scale or self.scale,
                            variant=variant or self.variant)

    def get_scale(self, n, cell=0):
        scale = self.scale
        space_dim = self.ref_el.get_spatial_dimension()
        if isinstance(scale, str):
            vol = self.ref_el.volume_of_subcomplex(space_dim, cell)
            name = scale.lower()
            if name == "orthonormal":
                scale = math.sqrt(1.0 / vol)
            elif name == "l2 piola":
                scale = 1.0 / vol
        elif n == 0 and space_dim > 1 and len(self.affine_mappings) == 1:
            # Reference quirk: constant member is exactly 1 on single cells.
            scale = 1
        return scale

    def get_num_members(self, n):
        return polynomial_dimension(self.ref_el, n, self.continuity)

    def get_cell_node_map(self, n):
        try:
            return self._cell_node_map_cache[n]
        except KeyError:
            cnm = polynomial_cell_node_map(self.ref_el, n, self.continuity)
            return self._cell_node_map_cache.setdefault(n, cnm)

    # -- core tabulation ------------------------------------------------------

    def _tabulate_on_cell(self, n, pts, order=0, cell=0, direction=None):
        """dict alpha -> array (m, npts) of D^alpha phi_i(pts_j).

        Runs the member-vectorized recurrence; derivatives come from running
        it on Taylor jets in the cell coordinates (or a single jet variable
        when ``direction`` is given).  Works on numpy arrays (host) and on
        traced jnp arrays (inside jit)."""
        space_dim = self.ref_el.get_spatial_dimension()
        traced = _is_traced(pts)
        xp = jnp if traced else np
        if not traced:
            pts = np.asarray(pts, dtype=np.float64).reshape(-1, space_dim)
        A, b = self.affine_mappings[cell]
        scale = self.get_scale(n, cell=cell)
        ref = pts @ A.T + b                          # (npts, space_dim), default simplex
        vals = [ref[..., i] for i in range(space_dim)]
        npts = pts.shape[0]
        num_members = math.comb(n + space_dim, space_dim)

        if order == 0:
            out = dubiner_tabulate(space_dim, n, vals, scale, variant=self.variant, xp=xp)
            return {(0,) * space_dim: out}

        if direction is None:
            nvars, jac = space_dim, A
            alpha_of = lambda a: a
        else:
            nvars = 1
            jac = (A @ np.asarray(direction, dtype=np.float64)).reshape(space_dim, 1)
            alpha_of = lambda a: a + (0,) * (space_dim - 1)

        coords = taylor_seeds(vals, jac, nvars, order)
        out = dubiner_tabulate(space_dim, n, coords, scale, variant=self.variant, xp=xp)

        result = {}
        for alpha in multiindices(nvars, order):
            d = out.derivative(alpha)
            if d is None:
                d = xp.zeros((num_members, npts))
            result[alpha_of(alpha)] = d
        return result

    def _tabulate(self, n, pts, order=0):
        """Tabulate on the whole complex (single-cell case is the identity
        assembly; macro complexes bin points to subcells)."""
        if _is_traced(pts):
            if self.ref_el.is_macrocell():
                return self._tabulate_traced_macro(n, pts, order)
            return self._tabulate_on_cell(n, pts, order)
        pts = np.asarray(pts, dtype=np.float64)
        unique = self.continuity is not None and order == 0
        cell_point_map = compute_cell_point_map(self.ref_el, pts, unique=unique)
        phis = {c: self._tabulate_on_cell(n, pts[ipts if ipts is not Ellipsis else slice(None)],
                                          order, cell=c)
                for c, ipts in cell_point_map.items()}
        if not self.ref_el.is_macrocell():
            return phis[0]

        if not unique:
            mult = np.zeros(pts.shape[:-1])
            for c, ipts in cell_point_map.items():
                mult[ipts] += 1
            for c, ipts in cell_point_map.items():
                for alpha in phis[c]:
                    phis[c][alpha] /= mult[None, ipts]

        num_phis = self.get_num_members(n)
        cell_node_map = self.get_cell_node_map(n)
        result = {}
        probe = next(iter(phis.values()))
        for alpha in probe:
            out = np.zeros((num_phis, *pts.shape[:-1]), dtype=probe[alpha].dtype)
            for c in cell_point_map:
                ibfs = cell_node_map[c]
                ipts = cell_point_map[c]
                if ipts is Ellipsis:
                    out[ibfs, ...] += phis[c][alpha]
                else:
                    out[np.ix_(ibfs, ipts)] += phis[c][alpha]
            result[alpha] = out
        return result

    def _tabulate_traced_macro(self, n, pts, order=0):
        """Shape-static traced tabulation on a macro complex: every
        subcell tabulates at EVERY point and the results combine through
        {0,1} partition-of-unity masks (no data-dependent gather, so the
        whole thing jits; the reference's symbolic PoU dual,
        FIAT/expansions.py:732, made concrete)."""
        unique = self.continuity is not None and order == 0
        masks = partition_of_unity_masks(self.ref_el, pts, unique=unique)
        top = self.ref_el.get_topology()
        space_dim = self.ref_el.get_spatial_dimension()
        num_phis = self.get_num_members(n)
        cell_node_map = self.get_cell_node_map(n)
        result = {}
        for pos, c in enumerate(sorted(top[space_dim])):
            phis = self._tabulate_on_cell(n, pts, order, cell=c)
            for alpha, tab in phis.items():
                if alpha not in result:
                    result[alpha] = jnp.zeros(
                        (num_phis,) + tab.shape[1:], dtype=tab.dtype)
                result[alpha] = result[alpha].at[cell_node_map[c]].add(
                    masks[pos] * tab)
        return result

    def tabulate(self, n, pts):
        if len(pts) == 0:
            return np.array([])
        space_dim = self.ref_el.get_spatial_dimension()
        return self._tabulate(n, pts)[(0,) * space_dim]

    def tabulate_derivatives(self, n, pts):
        vals = self._tabulate(n, pts, order=1)
        space_dim = self.ref_el.get_spatial_dimension()
        v = vals[(0,) * space_dim]
        dv = [vals[alpha] for alpha in mis(space_dim, 1)]
        return [[(v[i, j], [vi[i, j] for vi in dv])
                 for j in range(v.shape[1])]
                for i in range(v.shape[0])]

    def tabulate_jet(self, n, pts, order=1):
        vals = self._tabulate(n, pts, order=order)
        space_dim = self.ref_el.get_spatial_dimension()
        v0 = vals[(0,) * space_dim]
        data = [v0]
        for r in range(1, order + 1):
            vr = np.zeros((space_dim,) * r + v0.shape, dtype=v0.dtype)
            for index in np.ndindex(vr.shape[:r]):
                vr[index] = vals[tuple(map(index.count, range(space_dim)))]
            data.append(vr.transpose((r, r + 1) + tuple(range(r))))
        return data

    # -- jumps on macro complexes ---------------------------------------------

    def tabulate_normal_jumps(self, n, ref_pts, facet, order=0):
        """Normal-derivative jumps of the expansion at reference points of a
        facet of the complex."""
        space_dim = self.ref_el.get_spatial_dimension()
        transform = self.ref_el.get_entity_transform(space_dim - 1, facet)
        pts = np.asarray(transform(ref_pts))
        cell_point_map = compute_cell_point_map(self.ref_el, pts, unique=False)
        cell_node_map = self.get_cell_node_map(n)
        num_phis = self.get_num_members(n)
        results = np.zeros((order + 1, num_phis, *pts.shape[:-1]))
        for c, ipts in cell_point_map.items():
            normal = self.ref_el.compute_normal(facet, cell=c)
            side = np.dot(normal, self.ref_el.compute_normal(facet))
            sel = slice(None) if ipts is Ellipsis else ipts
            phi = self._tabulate_on_cell(n, pts[sel], order, cell=c)
            v0 = phi[(0,) * space_dim]
            ibfs = cell_node_map[c]
            for r in range(order + 1):
                vr = np.zeros((space_dim,) * r + v0.shape, dtype=v0.dtype)
                for index in np.ndindex(vr.shape[:r]):
                    vr[index] = phi[tuple(map(index.count, range(space_dim)))]
                for _ in range(r):
                    vr = np.tensordot(normal, vr, axes=(0, 0))
                indices = np.ix_(ibfs, np.arange(pts.shape[0])[sel])
                if r % 2 == 0 and side < 0:
                    results[r][indices] -= vr
                else:
                    results[r][indices] += vr
        return results

    def tabulate_jumps(self, n, points, order=0):
        """Derivative jumps across interior facets of the complex."""
        space_dim = self.ref_el.get_spatial_dimension()
        num_members = self.get_num_members(n)
        cell_node_map = self.get_cell_node_map(n)
        points = np.asarray(points, dtype=np.float64)
        cell_point_map = compute_cell_point_map(self.ref_el, points, unique=False)

        num_jumps = 0
        facet_point_map = {}
        for facet in self.ref_el.get_interior_facets(space_dim - 1):
            cells_ = self.ref_el.connectivity[(space_dim - 1, space_dim)][facet]
            # a jump needs the point binned to BOTH adjacent cells; a cell
            # with no points at all contributes the empty set
            ipts = list(set.intersection(
                *(set(np.atleast_1d(cell_point_map.get(c, ())))
                  for c in cells_)))
            if ipts:
                facet_point_map[facet] = ipts
                num_jumps += len(ipts)

        derivs = {c: self._tabulate_on_cell(n, points, order=order, cell=c)
                  for c in cell_point_map}
        jumps = {}
        for r in range(order + 1):
            cur = 0
            alphas = mis(space_dim, r)
            jumps[r] = np.zeros((num_members, len(alphas) * num_jumps))
            for facet, ipts in facet_point_map.items():
                c0, c1 = self.ref_el.connectivity[(space_dim - 1, space_dim)][facet]
                for alpha in alphas:
                    ijump = range(cur, cur + len(ipts))
                    jumps[r][np.ix_(cell_node_map[c1], ijump)] += derivs[c1][alpha][:, ipts]
                    jumps[r][np.ix_(cell_node_map[c0], ijump)] -= derivs[c0][alpha][:, ipts]
                    cur += len(ipts)
        return jumps

    # -- spectral differentiation matrices --------------------------------------

    def get_dmats(self, degree, cell=0):
        """dmat[k, j, i]: coefficients of d(phi_j)/dx_k in the expansion
        basis, from a collocation solve at a Gauss-Legendre lattice."""
        key = (degree, cell)
        try:
            return self._dmats_cache[key]
        except KeyError:
            pass
        space_dim = self.ref_el.get_spatial_dimension()
        if degree == 0:
            return self._dmats_cache.setdefault(key, np.zeros((space_dim, 1, 1)))
        top = self.ref_el.get_topology()
        verts = self.ref_el.get_vertices_of_subcomplex(top[space_dim][cell])
        pts = cl.make_lattice(verts, degree, variant="gl")
        v = self._tabulate_on_cell(degree, pts, order=1, cell=cell)
        dv = [np.transpose(v[alpha]) for alpha in mis(space_dim, 1)]
        dmats = np.linalg.solve(np.transpose(v[(0,) * space_dim]), dv)
        return self._dmats_cache.setdefault(key, dmats)

    def __eq__(self, other):
        return (type(self) is type(other) and self.ref_el == other.ref_el
                and self.continuity == other.continuity)

    def __hash__(self):
        return hash((type(self), self.ref_el, self.continuity))


class PointExpansionSet(ExpansionSet):
    def __init__(self, ref_el, **kwargs):
        if ref_el.get_spatial_dimension() != 0:
            raise ValueError("Must have a point")
        super().__init__(ref_el, **kwargs)

    def _tabulate_on_cell(self, n, pts, order=0, cell=0, direction=None):
        assert n == 0 and order == 0
        return {(): np.ones((1, len(pts)))}


class LineExpansionSet(ExpansionSet):
    def __init__(self, ref_el, **kwargs):
        if ref_el.get_spatial_dimension() != 1:
            raise ValueError("Must have a line")
        super().__init__(ref_el, **kwargs)


class TriangleExpansionSet(ExpansionSet):
    def __init__(self, ref_el, **kwargs):
        if ref_el.get_spatial_dimension() != 2:
            raise ValueError("Must have a triangle")
        super().__init__(ref_el, **kwargs)


class TetrahedronExpansionSet(ExpansionSet):
    def __init__(self, ref_el, **kwargs):
        if ref_el.get_spatial_dimension() != 3:
            raise ValueError("Must have a tetrahedron")
        super().__init__(ref_el, **kwargs)


# ---------------------------------------------------------------------------
# Complex-wide numbering helpers

def polynomial_dimension(ref_el, n, continuity=None):
    if ref_el.get_shape() == cl.POINT:
        if n > 0:
            raise ValueError("Only degree-0 polynomials on a point")
        return 1
    top = ref_el.get_topology()
    if isinstance(continuity, dict):
        return sum(len(continuity[dim][0]) * len(top[dim]) for dim in top)
    if continuity == "C0":
        return sum(math.comb(n - 1, dim) * len(top[dim]) for dim in top)
    dim = ref_el.get_spatial_dimension()
    return math.comb(n + dim, dim) * len(top[dim])


def polynomial_entity_ids(ref_el, n, continuity=None):
    top = ref_el.get_topology()
    space_dim = ref_el.get_spatial_dimension()
    entity_ids = {}
    cur = 0
    for dim in sorted(top):
        if isinstance(continuity, dict):
            dofs, = set(len(continuity[dim][e]) for e in continuity[dim])
        elif continuity == "C0":
            dofs = math.comb(n - 1, dim)
        else:
            dofs = math.comb(n + dim, dim) if dim == space_dim else 0
        entity_ids[dim] = {e: list(range(cur + i * dofs, cur + (i + 1) * dofs))
                           for i, e in enumerate(sorted(top[dim]))}
        cur += dofs * len(top[dim])
    return entity_ids


def polynomial_cell_node_map(ref_el, n, continuity=None):
    top = ref_el.get_topology()
    space_dim = ref_el.get_spatial_dimension()
    entity_ids = polynomial_entity_ids(ref_el, n, continuity)
    ref_ids = polynomial_entity_ids(ref_el.construct_subelement(space_dim), n, continuity)
    num_cells = len(top[space_dim])
    dofs_per_cell = sum(len(ref_ids[dim][e]) for dim in ref_ids for e in ref_ids[dim])
    cell_node_map = np.zeros((num_cells, dofs_per_cell), dtype=int)
    conn = ref_el.get_cell_connectivity()
    for c in top[space_dim]:
        for dim in top:
            for ref_e, e in enumerate(conn[c][dim]):
                cell_node_map[c, ref_ids[dim][ref_e]] = entity_ids[dim][e]
    return cell_node_map


def compute_cell_point_map(ref_el, pts, unique=True, tol=1e-12):
    """Bin points to the nearest subcell of a complex.  Returns
    {cell: point-index-array or Ellipsis}."""
    top = ref_el.get_topology()
    space_dim = ref_el.get_spatial_dimension()
    if len(top[space_dim]) == 1:
        return {0: Ellipsis}
    pts = np.asarray(pts)
    best = ref_el.get_parent().distance_to_point_l1(pts, rescale=True)
    tol = best + tol
    out = {}
    for c in sorted(top[space_dim]):
        near = ref_el.distance_to_point_l1(pts, entity=(space_dim, c), rescale=True) < tol
        if near.ndim == 0:
            if near:
                out[c] = Ellipsis
                if unique:
                    break
        else:
            if unique:
                for other in out.values():
                    near[other] = False
            ipts = np.where(near)[0]
            if len(ipts) > 0:
                out[c] = ipts
    return out


def partition_of_unity_masks(ref_el, pts, unique=True, tol=1e-12, raw=False):
    """Traceable analogue of the reference's symbolic partition-of-unity
    (expansions.py:732): per-subcell {0,1} masks over a point batch, for
    shape-static macro tabulation on device.

    Distances run in f64, or on the df32 path (ops/doublefloat.py) when
    the batch is f64 and the platform's f64 engine is the emulated one
    (ops.f64_engine) on a backend that keeps error-free transforms
    exact: f32 speed with ~1e-14 absolute accuracy at the facets.  Either
    way the binning tolerance is the host's 1e-12: the f64 barycentric
    map promotes f32 batches (cells.compute_barycentric_coordinates).
    (A plain-f32 distance would need tol ~1e-5 above its cancellation
    noise, and every point within that band of an interior facet would
    pick up O(|jump| * tol) error in derivative tables.)"""
    from ..ops.doublefloat import df32_live
    top = ref_el.get_topology()
    space_dim = ref_el.get_spatial_dimension()
    if getattr(pts, "dtype", None) == jnp.float64 and df32_live():
        from ..ops.doublefloat import ff_l1_distance
        parent = ref_el.get_parent()
        best = ff_l1_distance(pts, *parent.barycentric_map(rescale=True))
        dists = {c: ff_l1_distance(
            pts, *ref_el.barycentric_map(entity=(space_dim, c), rescale=True))
            for c in sorted(top[space_dim])}
    else:
        best = ref_el.get_parent().distance_to_point_l1(pts, rescale=True)
        dists = {c: ref_el.distance_to_point_l1(pts, entity=(space_dim, c),
                                                rescale=True)
                 for c in sorted(top[space_dim])}
    masks = []
    taken = 0.0
    for c in sorted(top[space_dim]):
        near = dists[c] <= best + tol
        m = jnp.where(near, 1.0, 0.0)
        if unique:
            m = m * (1.0 - taken)
            taken = jnp.maximum(taken, m)
        masks.append(m)
    if raw:
        return masks, (None if unique else sum(masks))
    if not unique:
        total = sum(masks)
        masks = [m / total for m in masks]
    return masks
