"""The device tabulation engine.

This is the device replacement for the reference's per-call numpy
tabulation loop (FIAT/finite_element.py:181, FIAT/polynomial_set.py:68):

* ``ElementTabulator`` compiles one element's ``tabulate(order, points)``
  into a single jitted XLA program: the Dubiner recurrence runs as a fused
  elementwise program over the whole point batch, and the nodal-basis
  contraction ``coeffs @ phi`` is one dense matmul.
* ``BatchedTabulator`` fuses MANY elements (sharing a reference cell) into
  ONE program: every element's coefficients are re-expressed in the plain
  orthonormal Dubiner basis of the maximum embedded degree (lower-degree
  bases are prefixes of higher-degree ones under the morton ordering), the
  coefficient blocks are stacked, and the whole zoo tabulates with a single
  [sum(nbf_i * ncomp_i), nexp] x [nexp, npts] matmul.

Precision: tabulation runs in the dtype of the input points; float64 meets
the 1e-10 reproduction tolerance.  Every dot asks for
``Precision.HIGHEST``, so float32 tables do not drop to TF32 on a GPU.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..core import expansions

#: Point-batch tile size: the expansion recurrence is evaluated tile by tile
#: (jax.lax.map) so the unrolled recurrence's live intermediates stay inside
#: a bounded working set instead of scaling with the full batch.  Not yet
#: swept on the H100 (ROADMAP A4).
DEFAULT_TILE = 8192

#: recurrence working-set target (expansion members x points) behind the
#: adaptive tile: DEFAULT_TILE at the full zoo's nexp=66; small bases get
#: proportionally longer tiles (lax.map runs tiles SEQUENTIALLY, so tiny
#: programs would otherwise pay ~50 kernel dispatches per pass)
_WORKSET = DEFAULT_TILE * 66


def _dot(a, b):
    """a @ b in the dtype of ``a``, the change-of-basis matrix cast to the
    points' dtype.  ``b``, an expansion table, follows it: its recurrence
    constants are f64, so it comes out of the recurrence in f64.  The
    precision is full: a GPU would otherwise run an f32 dot in TF32
    (~1e-3 relative)."""
    return jnp.matmul(a, b.astype(a.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def _engine(matmul):
    """The f64 engine a tabulator runs: ``matmul`` if given, else the
    platform's (ops.f64_engine)."""
    if matmul is None:
        from . import f64_engine
        return f64_engine()
    if matmul not in ("native", "ozaki"):
        raise ValueError(f"matmul must be 'native' or 'ozaki', not {matmul!r}")
    return matmul


def adaptive_tile(nexp, tile=None):
    """Tile size keeping nexp * tile ~ constant, 512-aligned."""
    if tile is not None:
        return tile
    return max(DEFAULT_TILE, (_WORKSET // max(nexp, 1)) // 512 * 512)


def _tiled_apply(body, points, tile):
    """Apply ``body: (t, sd) -> {alpha: (rows, t)}`` over a large point
    batch in fixed-size tiles via lax.map, concatenating on the point axis."""
    npts, sd = points.shape
    if npts <= tile:
        return body(points)
    ntiles = -(-npts // tile)
    pad = ntiles * tile - npts
    padded = jnp.pad(points, ((0, pad), (0, 0)))
    tiles = padded.reshape(ntiles, tile, sd)
    stacked = jax.lax.map(body, tiles)     # {alpha: (ntiles, rows, tile)}
    out = {}
    for alpha, tab in stacked.items():
        full = jnp.moveaxis(tab, 0, -2).reshape(tab.shape[1], ntiles * tile)
        out[alpha] = full[..., :npts]
    return out


class ElementTabulator:
    """Jit-compiled tabulation of a single (Ciarlet) element.

    Usage: ``tab = ElementTabulator(element, order); tables = tab(points)``
    with ``points`` of shape (npts, sd); returns {alpha: jnp array} like the
    host API.
    """

    def __init__(self, element, order=0, tile=None, matmul=None):
        """:arg matmul: the f64 engine, 'native' or 'ozaki'; by default
        the platform's (ops.f64_engine)."""
        self.element = element
        self.order = order
        self.matmul = _engine(matmul)
        poly_set = element.get_nodal_basis()
        self.coeffs = np.asarray(poly_set.get_coeffs())
        self.expansion_set = poly_set.get_expansion_set()
        self.embedded_degree = poly_set.get_embedded_degree()
        self.tile = adaptive_tile(
            self.expansion_set.get_num_members(self.embedded_degree), tile)
        self.sd = element.get_reference_element().get_spatial_dimension()
        if self.matmul == "ozaki":
            from .multiword import MultiwordMatmul
            from .doublefloat import supports_ff
            self._mw = MultiwordMatmul(
                self.coeffs.reshape(-1, self.coeffs.shape[-1]))
            # evaluated eagerly: the EFT-safety probe jit-compiles, so it
            # cannot run while this tabulator itself is being traced
            self._ff_ok = self.order == 0 and supports_ff(self.expansion_set)
        self._jitted = jax.jit(self._tabulate)

    def _tabulate(self, points):
        coeffs = jnp.asarray(self.coeffs, dtype=points.dtype)
        flat = coeffs.reshape(-1, coeffs.shape[-1])
        use_ozaki = (self.matmul == "ozaki"
                     and points.dtype == jnp.float64)

        from .doublefloat import prepare_B_ff, tabulate_ff
        ff_ok = self.matmul == "ozaki" and self._ff_ok

        def body(pts):
            if use_ozaki and ff_ok:
                phi_p = prepare_B_ff(tabulate_ff(
                    self.expansion_set, self.embedded_degree, pts))
                return {(0,) * self.sd: self._mw.apply(phi_p)}
            base = self.expansion_set._tabulate_on_cell(
                self.embedded_degree, pts, order=self.order)
            if use_ozaki:
                from .multiword import prepare_B
                return {alpha: self._mw.apply(prepare_B(tab))
                        for alpha, tab in base.items()}
            return {alpha: _dot(flat, tab) for alpha, tab in base.items()}

        out = _tiled_apply(body, points, self.tile)
        return {alpha: vals.reshape(coeffs.shape[:-1] + vals.shape[-1:])
                for alpha, vals in out.items()}

    def __call__(self, points):
        return self._jitted(jnp.asarray(points))

    def lowered(self, npts, dtype=jnp.float64):
        return self._jitted.lower(
            jax.ShapeDtypeStruct((npts, self.sd), dtype))


def change_of_basis(expansion_set, degree, target_expansion_set, target_degree):
    """T with phi_src_i = sum_j T[i, j] phi_tgt_j, by collocation at a
    Gauss-Legendre lattice (exact: both bases span subsets of P_target)."""
    from ..core import cells as cl
    ref_el = expansion_set.ref_el
    sd = ref_el.get_spatial_dimension()
    top = ref_el.get_topology()
    verts = ref_el.get_vertices_of_subcomplex(top[sd][0])
    pts = cl.make_lattice(verts, target_degree, variant="gl")
    src = expansion_set.tabulate(degree, pts)            # (m_src, npts)
    tgt = target_expansion_set.tabulate(target_degree, pts)   # (m_tgt, npts)
    return np.linalg.solve(tgt.T, src.T).T               # (m_src, m_tgt)


class MacroSideProgram:
    """Batched tabulation of macro (split-complex) elements sharing one
    expansion set and degree, in the dmats form.

    Per subcell c the macro basis rows supported on c restrict to the
    cell's polynomial basis Phi_c; Phi_c extends polynomially to the whole
    parent cell, so Phi_c = T_c @ Phi_parent exactly.  Every derivative
    table therefore reads

      D^alpha table = sum_c (flat[:, nodes_c] D_c^alphaT T_c) @ (mask_c * Phi)

    with Phi the PARENT-cell orthonormal tabulation computed ONCE per
    pass (no per-subcell recurrences, no per-alpha jets) and one tall
    GEMM covering all member elements and derivative multi-indices."""

    def __init__(self, es, degree, members, alphas):
        """:arg members: [(element_index, flat_coeffs (rows_e, num_phis))]
        :arg alphas: derivative multi-indices (the (0,..,0) value entry
        first)."""
        self.es = es
        self.degree = degree
        self.alphas = list(alphas)
        top = es.ref_el.get_topology()
        sd = es.ref_el.get_spatial_dimension()
        self.cells = sorted(top[sd])
        cnm = es.get_cell_node_map(degree)

        parent = es.ref_el.get_parent()
        self.parent_es = expansions.ExpansionSet(parent)
        self.nexp_parent = self.parent_es.get_num_members(degree)
        # subcell basis -> parent basis by collocation at a GL lattice
        from ..core import cells as cl
        lat = cl.make_lattice(parent.get_vertices(), max(degree, 1),
                              variant="gl")
        tgt = self.parent_es.tabulate(degree, lat)
        T = {}
        for c in self.cells:
            src = es._tabulate_on_cell(degree, np.asarray(lat), order=0,
                                       cell=c)[(0,) * sd]
            T[c] = np.linalg.solve(tgt.T, np.asarray(src).T).T

        blocks = {a: [] for a in self.alphas}
        self.row_slices = []
        cursor = 0
        for idx, flat in members:
            for alpha in self.alphas:
                row = []
                for c in self.cells:
                    M = flat[:, cnm[c]]
                    D = es.get_dmats(degree, cell=c)
                    for k, ak in enumerate(alpha):
                        for _ in range(ak):
                            M = M @ np.transpose(D[k])
                    row.append(M @ T[c])
                blocks[alpha].append(np.hstack(row))
            self.row_slices.append((idx, cursor, cursor + flat.shape[0]))
            cursor += flat.shape[0]
        self.rows = cursor
        # (nalpha * rows, ncells * nexp_parent): alpha-major, element-minor
        self.tall = np.vstack([np.vstack(blocks[a]) for a in self.alphas])
        self.K = self.tall.shape[1]

    def b_stack(self, pts, order):
        """Stacked masked parent tabulation (ncells * nexp_parent, npts);
        the mask convention follows the traced-macro engine (unique
        binning for order 0, averaged multiplicities otherwise)."""
        from ..core.expansions import partition_of_unity_masks
        unique = self.es.continuity is not None and order == 0
        masks = partition_of_unity_masks(self.es.ref_el, pts, unique=unique)
        phi = self.parent_es._tabulate_on_cell(self.degree, pts, order=0)
        phi = phi[(0,) * pts.shape[-1]]
        return jnp.concatenate([masks[pos].astype(pts.dtype) * phi
                                for pos, c in enumerate(self.cells)], axis=0)

    def b_stack_ff(self, pts, order):
        """The stacked masked parent tabulation as a df32 (hi, lo) pair
        (ncells * nexp_parent, npts), entirely in native f32: the parent
        recurrence runs on the two-float path (ops/doublefloat.py), the
        {0,1} binning masks multiply both words exactly, and non-unique
        multiplicity averaging divides through an error-free-refined FF
        reciprocal.  Callers gate on ``supports_ff(self.parent_es)``."""
        from ..core.expansions import partition_of_unity_masks
        from .doublefloat import FF, ff_mul, ff_recip_int, tabulate_ff
        unique = self.es.continuity is not None and order == 0
        masks, total = partition_of_unity_masks(self.es.ref_el, pts,
                                                unique=unique, raw=True)
        ff = tabulate_ff(self.parent_es, self.degree, pts)
        his, los = [], []
        for pos, c in enumerate(self.cells):
            m = masks[pos].astype(jnp.float32)
            his.append(m * ff.hi)
            los.append(m * ff.lo)
        out = FF(jnp.concatenate(his, axis=0), jnp.concatenate(los, axis=0))
        if total is not None:
            out = ff_mul(out, ff_recip_int(total.astype(jnp.float32)))
        return out

    def tables(self, pts, order):
        """{alpha: (rows, npts)} via one tall GEMM."""
        out = _dot(jnp.asarray(self.tall, dtype=pts.dtype),
                   self.b_stack(pts, order))
        r = self.rows
        return {a: out[k * r:(k + 1) * r] for k, a in enumerate(self.alphas)}


class BatchedTabulator:
    """Tabulate a whole family zoo (same reference cell) in one program.

    All element coefficient tensors are rewritten over the plain Dubiner
    basis of the maximum embedded degree and stacked into one matrix, so the
    entire sweep is ONE recurrence evaluation + ONE large matmul per
    derivative multi-index.
    """

    def __init__(self, elements, order=0, tile=None,
                 derivs="dmats", matmul=None, dtype=None):
        """:arg derivs: 'dmats' (default) computes derivative tables as
        extra matmuls against the order-0 expansion (exact spectral
        differentiation; the recurrence runs once, on plain values),
        'jets' runs the Taylor-jet recurrence (order-proportional
        elementwise work).
        :arg matmul: the f64 engine.  'native' uses the platform's f64
        recurrence and dot; 'ozaki' the df32 recurrence (where the
        backend keeps error-free transforms exact) and the multiword
        bf16 scheme (ops/multiword.py, ~3e-14 relative).  By default the
        platform's engine (ops.f64_engine).
        :arg dtype: the dtype points are cast to; by default the
        caller's."""
        self.derivs = derivs
        self.matmul = _engine(matmul)
        self.dtype = dtype
        self._tile_arg = tile
        cells = {e.get_reference_element() for e in elements}
        if len(cells) != 1:
            raise ValueError("BatchedTabulator needs a common reference cell")
        self.ref_el, = cells
        if not all(getattr(e, "is_nodal", lambda: False)()
                   or e.is_macroelement() for e in elements):
            raise NotImplementedError(
                "BatchedTabulator fuses nodal (Ciarlet) bases; for "
                "tensor-product/hypercube elements jit the symbolic "
                "layer's factored basis_evaluation instead "
                "(fiat_tpu.symbolic, docs/symbolic.md)")
        self.elements = list(elements)
        self.order = order
        self.sd = self.ref_el.get_spatial_dimension()

        # partition: 'plain' elements share the fused change-of-basis
        # matmul; macro elements (split-complex expansions) each get a
        # side program using the traced partition-of-unity tabulation
        plain = [e for e in self.elements if not e.is_macroelement()]
        self.special = [(i, e) for i, e in enumerate(self.elements)
                        if e.is_macroelement()]
        if not plain:
            raise ValueError(
                "BatchedTabulator needs at least one non-macro element")

        self.max_degree = max(e.get_nodal_basis().get_embedded_degree()
                              for e in plain)
        self.target_es = expansions.ExpansionSet(self.ref_el)
        nexp = self.target_es.get_num_members(self.max_degree)
        self.tile = adaptive_tile(nexp, self._tile_arg)

        blocks = []
        plain_slices = {}      # element index -> (start, stop, shape)
        cursor = 0
        for i, e in enumerate(self.elements):
            if e.is_macroelement():
                continue
            ps = e.get_nodal_basis()
            es = ps.get_expansion_set()
            deg = ps.get_embedded_degree()
            coeffs = np.asarray(ps.get_coeffs())
            if (type(es) is type(self.target_es) and es.variant is None
                    and es.ref_el == self.ref_el):
                # plain Dubiner: prefix embedding, just zero-pad -- up
                # to the normalisation scale, which is DEGREE-dependent
                # (1 at degree 0, sqrt(1/|K|) past it, mirroring the
                # reference's convention), so a degree-0 member (P0/DG0)
                # embeds with the scale ratio
                ratio = float(np.asarray(es.get_scale(deg))
                              / np.asarray(self.target_es.get_scale(
                                  self.max_degree)))
                T = np.zeros((coeffs.shape[-1], nexp))
                T[:, :coeffs.shape[-1]] = ratio * np.eye(coeffs.shape[-1])
            else:
                T = change_of_basis(es, deg, self.target_es, self.max_degree)
            flat = coeffs.reshape(-1, coeffs.shape[-1]) @ T
            blocks.append(flat)
            plain_slices[i] = (cursor, cursor + flat.shape[0],
                               coeffs.shape[:-1])
            cursor += flat.shape[0]
        self.stacked = np.vstack(blocks)          # (plain_rows, nexp)

        # macro side programs: (expansion set, degree, flat coeffs)
        self.special_progs = []
        special_slices = {}
        for i, e in self.special:
            ps = e.get_nodal_basis()
            coeffs = np.asarray(ps.get_coeffs())
            flat = coeffs.reshape(-1, coeffs.shape[-1])
            self.special_progs.append(
                (ps.get_expansion_set(), ps.get_embedded_degree(), flat))
            special_slices[i] = (cursor, cursor + flat.shape[0],
                                 coeffs.shape[:-1])
            cursor += flat.shape[0]

        self.slices = [plain_slices.get(i) or special_slices[i]
                       for i in range(len(self.elements))]

        # one change-of-basis matrix per derivative multi-index:
        # D^alpha phi = (prod_k dmats[k]^T^alpha_k) @ phi, so the
        # derivative tables are extra matmuls against the SAME order-0
        # expansion (exact for polynomials; FIAT's dmats path,
        # FIAT/expansions.py:495 & polynomial_set.py tabulate)
        self.alpha_mats = {}
        if self.order > 0 and self.derivs == "dmats":
            D = self.target_es.get_dmats(self.max_degree)
            for total in range(self.order + 1):
                for alpha in expansions.multiindices(self.sd, total):
                    M = self.stacked
                    for k, ak in enumerate(alpha):
                        for _ in range(ak):
                            M = M @ np.transpose(D[k])
                    self.alpha_mats[alpha] = M
            self._alpha_order = list(self.alpha_mats)

        # macro side programs in the dmats form: one tall GEMM per group
        # of macro elements sharing an expansion set (no per-alpha jets)
        self.macro_programs = []
        if self.special and (self.derivs == "dmats" or self.order == 0):
            alphas_all = (self._alpha_order if self.order > 0
                          else [(0,) * self.sd])
            groups = {}
            for (i, e), (es, deg, flat) in zip(self.special,
                                               self.special_progs):
                groups.setdefault((id(es), deg), (es, deg, []))[2].append(
                    (i, flat))
            for es, deg, mem in groups.values():
                self.macro_programs.append(
                    MacroSideProgram(es, deg, mem, alphas_all))

        #: the df32 pair paths (recurrence, moments, point values) are
        #: live: the emulated engine on a backend that keeps error-free
        #: transforms exact.  Evaluated eagerly: the EFT-safety probe
        #: jit-compiles, so it cannot run while this tabulator is traced.
        self._ff_ok = False
        if self.matmul == "ozaki":
            from .multiword import MultiwordMatmul
            from .doublefloat import supports_ff
            if self.alpha_mats:
                self._mw = {a: MultiwordMatmul(M)
                            for a, M in self.alpha_mats.items()}
            else:
                self._mw = {None: MultiwordMatmul(self.stacked)}
            self._ff_ok = supports_ff(self.target_es)
        self._jitted = jax.jit(self._tabulate)

    def _tabulate(self, points):
        use_ozaki = (self.matmul == "ozaki"
                     and points.dtype == jnp.float64)
        if self.alpha_mats:
            if use_ozaki:
                from .multiword import prepare_B
                from .doublefloat import prepare_B_ff, tabulate_ff
                ff_ok = self._ff_ok

                def body(pts):
                    if ff_ok:
                        phi_p = prepare_B_ff(
                            tabulate_ff(self.target_es, self.max_degree,
                                        pts))
                    else:
                        base = self.target_es._tabulate_on_cell(
                            self.max_degree, pts, order=0)
                        phi_p = prepare_B(base[(0,) * self.sd])
                    return {alpha: mw.apply(phi_p)
                            for alpha, mw in self._mw.items()}
            else:
                mats = {alpha: jnp.asarray(M, dtype=points.dtype)
                        for alpha, M in self.alpha_mats.items()}

                def body(pts):
                    base = self.target_es._tabulate_on_cell(
                        self.max_degree, pts, order=0)
                    phi = base[(0,) * self.sd]
                    return {alpha: _dot(M, phi) for alpha, M in mats.items()}
        else:
            # jets mode (or order 0): ONE change-of-basis matrix applied
            # to every derivative table of the recurrence
            if use_ozaki:
                from .multiword import prepare_B
                from .doublefloat import prepare_B_ff, tabulate_ff
                mw = self._mw[None]
                ff_ok = self.order == 0 and self._ff_ok

                def body(pts):
                    if ff_ok:
                        return {(0,) * self.sd: mw.apply(prepare_B_ff(
                            tabulate_ff(self.target_es, self.max_degree,
                                        pts)))}
                    base = self.target_es._tabulate_on_cell(
                        self.max_degree, pts, order=self.order)
                    return {alpha: mw.apply(prepare_B(tab))
                            for alpha, tab in base.items()}
            else:
                stacked = jnp.asarray(self.stacked, dtype=points.dtype)

                def body(pts):
                    base = self.target_es._tabulate_on_cell(
                        self.max_degree, pts, order=self.order)
                    return {alpha: _dot(stacked, tab)
                            for alpha, tab in base.items()}

        if not self.special_progs:
            return _tiled_apply(body, points, self.tile)

        plain_body = body

        def full_body(pts):
            out = plain_body(pts)
            parts = {alpha: [tab] for alpha, tab in out.items()}
            if self.macro_programs:
                per_elem = {}
                for prog in self.macro_programs:
                    tabs = prog.tables(pts, self.order)
                    for idx, lo, hi in prog.row_slices:
                        per_elem[idx] = {a: t[lo:hi] for a, t in tabs.items()}
                for i, e in self.special:
                    for alpha in parts:
                        parts[alpha].append(per_elem[i][alpha])
            else:
                # jets fallback: per-element traced-macro tabulation
                for es, deg, flat in self.special_progs:
                    base = es._tabulate(deg, pts, order=self.order)
                    C = jnp.asarray(flat, dtype=pts.dtype)
                    for alpha, tab in base.items():
                        parts[alpha].append(_dot(C, tab))
            return {alpha: jnp.concatenate(blocks, axis=0)
                    for alpha, blocks in parts.items()}

        return _tiled_apply(full_body, points, self.tile)

    def __call__(self, points):
        """{alpha: (total_rows, npts)} fused tables; use ``unpack`` for
        per-element views."""
        return self._jitted(jnp.asarray(points, self.dtype))

    def unpack(self, tables):
        """Split fused tables back into the per-element layout."""
        out = []
        for (lo, hi, shape) in self.slices:
            out.append({alpha: tab[lo:hi].reshape(shape + tab.shape[-1:])
                        for alpha, tab in tables.items()})
        return out

    def _expansion_tables(self, points):
        """Raw orthonormal-expansion tables {alpha: (nexp, npts)} without
        the nodal change of basis.  This is the sum-factorised form:
        moments contract points against the (small) expansion FIRST, so
        the (total_rows, npts) nodal table is never materialised --
        the gem sum_factorise optimisation, done by associativity."""
        def body(pts):
            return self.target_es._tabulate_on_cell(self.max_degree, pts,
                                                    order=self.order)
        return _tiled_apply(body, points, self.tile)

    def flop_count(self, npts):
        """Matmul flops for one application (cost-model hook)."""
        rows, nexp = self.stacked.shape
        alphas = len(expansions.multiindices(self.sd, self.order))
        return 2 * rows * nexp * npts * alphas
