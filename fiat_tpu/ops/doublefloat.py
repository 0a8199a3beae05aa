"""Double-float (two-f32) arithmetic and the df32 Dubiner recurrence.

The emulated f64 engine ("ozaki", ops.f64_engine) serves platforms
without f64 units, where XLA emulates every f64 elementwise op in ~30
f32 ops and the recurrence, not the matmul, dominates the pass once the
change of basis runs as bf16 products (ops/multiword.py).  This module
keeps that engine's whole B-side pipeline in native f32:

* error-free transformations (TwoSum, Veltkamp split, TwoProd) give
  ~49-bit "double-float" arithmetic out of paired f32 words -- the
  classic double-single scheme (Dekker 1971; the CUDA dsmath layout);
* :func:`dubiner_tabulate_ff` runs the member-vectorised Dubiner value
  recurrence (core/expansions.py:dubiner_tabulate) on FF pairs, with
  the static recurrence constants pre-split host-side so each
  const-times-point product costs one TwoProd with cached splits;
* :func:`prepare_B_ff` slices the FF tabulation into the fixed
  CHUNK-bit bf16 windows of the Ozaki scheme (ops/multiword.py) directly from the
  pair -- no f64 value ever materialises.

Accuracy: |hi + lo - exact| <~ 2^-48 relative through the recurrence
(regression-tested at ~1e-13 absolute vs the f64 recurrence), well
inside the framework's 1e-10 reproduction budget.
"""

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class FF(NamedTuple):
    """A double-float number/array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: object
    lo: object


def two_sum(a, b):
    """Error-free a + b (Knuth): s + e == a + b exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b requiring |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split32(a):
    """Split f32 into 12+12 bit halves (exact pairwise products).

    Implemented by masking the low 12 mantissa bits in the integer
    domain rather than the classical Veltkamp multiply (c = 4097*a;
    hi = c - (c - a)): compilers that allow FP contraction fuse
    Veltkamp's multiply-subtract into an FMA, which silently destroys
    the split (observed on XLA:CPU).  Integer masking is immune to
    every floating-point rewrite, and cheaper.  hi keeps the top 12
    mantissa bits (+ implicit), lo = a - hi is exact (Sterbenz) with
    <= 12 significant bits, so all cross products fit f32 exactly."""
    import jax
    if isinstance(a, np.ndarray) or np.isscalar(a):
        bits = np.asarray(a, np.float32).view(np.uint32)
        hi = (bits & np.uint32(0xFFFFF000)).view(np.float32)
        return hi, np.float32(a) - hi
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & np.uint32(0xFFFFF000),
                                      jnp.float32)
    return hi, a - hi


def two_prod(a, b, a_split=None, b_split=None):
    """Error-free a * b: p + e == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = a_split if a_split is not None else split32(a)
    bh, bl = b_split if b_split is not None else split32(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ff_add(x, y):
    """FF + FF: the ACCURATE double-word add (AccurateDWPlusDW, Joldes,
    Muller & Popescu 2017; error <= 3u^2).  The cheap 11-op variant
    (one TwoSum + one renormalise) loses its compensation term whenever
    x.hi and y.hi cancel -- which happens at every polynomial root in a
    three-term recurrence -- so the robust 20-op form is required."""
    sh, sl = two_sum(x.hi, y.hi)
    th, tl = two_sum(x.lo, y.lo)
    vh, vl = fast_two_sum(sh, sl + th)
    hi, lo = fast_two_sum(vh, tl + vl)
    return FF(hi, lo)


def ff_neg(x):
    return FF(-x.hi, -x.lo)


def ff_sub(x, y):
    return ff_add(x, ff_neg(y))


def ff_mul(x, y, x_split=None, y_split=None):
    """FF * FF (double-single mul; pass cached Veltkamp splits of the
    hi words when a factor is reused)."""
    p, e = two_prod(x.hi, y.hi, x_split, y_split)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return FF(hi, lo)


def ff_scale_pow2(x, s):
    """x * s for s an exact power of two (error-free)."""
    return FF(x.hi * s, x.lo * s)


def ff_from_f64(x, xp=np):
    """Split a f64 array into an FF pair (keeps ~48 of the 53 bits)."""
    hi = x.astype(xp.float32) if hasattr(x, "astype") else xp.float32(x)
    lo = (x - hi.astype(xp.float64)).astype(xp.float32)
    return FF(hi, lo)


def ff_to_f64(x):
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


class _ConstFF(NamedTuple):
    """Host-precomputed FF constant with cached hi-word split."""
    hi: object
    lo: object
    sh: object      # split32(hi)[0]
    sl: object      # split32(hi)[1]

    @property
    def split(self):
        return (self.sh, self.sl)


def const_ff(x):
    """Pre-split FF constant from a host f64 array (f32 numpy words)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    sh, sl = split32(hi)
    return _ConstFF(hi, lo, sh, sl)


def ff_mul_const(c, x, x_split=None):
    """_ConstFF * FF with the constant's split reused."""
    return ff_mul(FF(c.hi, c.lo), x, x_split=c.split, y_split=x_split)


# ---------------------------------------------------------------------------
# The df32 Dubiner value recurrence (plain variant, single cell)

@lru_cache(maxsize=None)
def _stage_constants_ff(dim, n, codim):
    """FF-packaged recurrence constants of one codimension stage of
    core/expansions.py:_stage_constants (variant None)."""
    from ..core.expansions import _stage_constants
    a1, b1, general, perm, norms = _stage_constants(dim, n, codim, None)
    return (const_ff(a1), const_ff(b1),
            {i: tuple(const_ff(v) for v in abc) for i, abc in general.items()},
            perm, const_ff(norms))


def dubiner_tabulate_ff(dim, n, coords, scale):
    """FF tabulation (num_members, npts) of the plain Dubiner basis at
    FF point coordinates on the default (-1,1) simplex.  Mirrors
    core/expansions.py:dubiner_tabulate (order-0, variant=None)."""
    if dim > 3:
        raise ValueError("Only dim <= 3 simplices supported")
    x0 = coords[0]
    npts = x0.hi.shape[-1] if hasattr(x0.hi, "shape") else 1
    sc = const_ff(np.asarray(scale, dtype=np.float64))
    R = FF(jnp.full((1, npts), sc.hi), jnp.full((1, npts), sc.lo))
    if n == 0:
        return R

    neg1 = FF(np.float32(-1.0), np.float32(0.0))
    X = tuple(coords) + (neg1, neg1)
    half = np.float32(0.5)
    one = FF(np.float32(1.0), np.float32(0.0))
    for codim in range(dim):
        x, y, z = X[codim], X[codim + 1], X[codim + 2]
        fb = ff_scale_pow2(ff_add(y, z), half)
        fa = ff_add(ff_add(x, fb), one)
        fb_split = split32(fb.hi)
        fa_split = split32(fa.hi)
        fc = ff_mul(fb, fb, x_split=fb_split, y_split=fb_split)
        fc_split = split32(fc.hi)
        a1, b1, general, perm, norms = _stage_constants_ff(dim, n, codim)
        levels = [R]
        if n >= 1:
            u = ff_sub(ff_mul_const(a1, fa, fa_split),
                       ff_mul_const(b1, fb, fb_split))
            levels.append(ff_mul(u, R))
        for i in range(2, n + 1):
            a, b, c = general[i]
            u = ff_sub(ff_mul_const(a, fa, fa_split),
                       ff_mul_const(b, fb, fb_split))
            v = ff_mul_const(c, fc, fc_split)
            levels.append(ff_sub(ff_mul(u, levels[-1]),
                                 ff_mul(v, levels[-2])))
        big = FF(jnp.concatenate([L.hi for L in levels], axis=0),
                 jnp.concatenate([L.lo for L in levels], axis=0))
        R = ff_mul_const(norms, FF(big.hi[perm], big.lo[perm]))
    return R


def tabulate_ff(es, n, pts):
    """FF order-0 tabulation of a plain single-cell expansion set at f64
    device points; pair-accurate replacement for
    ``es._tabulate_on_cell(n, pts, order=0)``.

    Only valid for ``es.variant is None`` on a non-macro cell (the
    callers gate on :func:`supports_ff`)."""
    sd = es.ref_el.get_spatial_dimension()
    A, b = es.affine_mappings[0]
    scale = es.get_scale(n, cell=0)
    # the affine map touches npts * sd values -- emulated f64 here is
    # noise next to the recurrence, and keeps the mapping exact
    ref = pts @ jnp.asarray(A.T) + jnp.asarray(b)
    coords = [ff_from_f64(ref[..., i], xp=jnp) for i in range(sd)]
    return dubiner_tabulate_ff(sd, n, coords, scale)


_EFT_SAFE_CACHE = {}


def eft_safe():
    """True when the default backend executes error-free transforms
    faithfully under jit.

    XLA:CPU duplicates cheap multiplies into consumer fusions and lets
    LLVM contract them into FMAs, which silently desynchronises
    (hi, lo) pairs (hi becomes fma(a,b,e) while lo is derived from the
    separately rounded a*b) -- no XLA flag turns this off, so the only
    reliable detector is running the arithmetic: the probe squares a
    batch of pairs under jit and checks exactness against f64.

    The probe must compile, so it cannot run while a caller is being
    traced; there it conservatively reports False.  Tabulator
    constructors call it eagerly, so traced bodies read a warm cache."""
    import jax
    platform = jax.default_backend()
    try:
        return _EFT_SAFE_CACHE[platform]
    except KeyError:
        pass
    from jax._src import core as _core
    if not _core.trace_state_clean():
        # ops on fresh concrete arrays stay concrete inside a trace, so
        # probing the Tracer-ness of `zeros(1)+0.0` never fires; ask the
        # trace state directly
        return False
    h64 = np.linspace(0.11, 1.9, 64) * (1.0 + 1e-9)
    pair = ff_from_f64(h64)
    f = jax.jit(lambda h, l: tuple(ff_mul(FF(h, l), FF(h, l))))
    rh, rl = f(jnp.asarray(pair.hi), jnp.asarray(pair.lo))
    got = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    exact = (pair.hi.astype(np.float64) + pair.lo.astype(np.float64)) ** 2
    verdict = float(np.abs(got - exact).max()) < 1e-12
    return _EFT_SAFE_CACHE.setdefault(platform, verdict)


def df32_live():
    """True when the df32 paths run: the platform's f64 engine is the
    emulated one (ops.f64_engine) and its backend passes the EFT probe.
    (XLA:GPU passes the probe yet broke the full-size df32 recurrence:
    on an H100 its tables lost their low word, 4.5e-4 max abs error,
    PERF.md.)"""
    from . import f64_engine
    return f64_engine() == "ozaki" and eft_safe()


def supports_ff(es):
    """True when the expansion set's value tabulation runs on the df32
    path: plain Dubiner variant, single cell, and ``df32_live()``.
    Elsewhere the recurrence runs in f64."""
    from ..core.expansions import PointExpansionSet
    return (es.variant is None and len(es.affine_mappings) == 1
            and not isinstance(es, PointExpansionSet) and df32_live())


def ff_recip_int(n):
    """FF reciprocal of a small positive integer-valued f32 array (the
    multiplicity counts of non-unique macro point binning): r + r_lo ==
    1/n to ~2^-48 relative.  One f32 divide plus an error-free residual
    refinement (d = 1 - r*n computed via TwoProd is exact because r*n
    is within one ulp of 1)."""
    one = np.float32(1.0)
    r = one / n
    p, e = two_prod(r, n)
    d = (one - p) - e
    return FF(r, r * d)


# ---------------------------------------------------------------------------
# df32 simplex distances (macro-complex point binning)

def ff_l1_distance(pts, A, b):
    """L1 exterior distance of f64 device points to a simplex given its
    barycentric map (A, b): sum of the negative barycentric parts,
    returned as f32 with ~1e-14 ABSOLUTE accuracy near the boundary.

    This replaces both the emulated-f64 distance (slow where f64 is
    emulated) and the plain-f32 distance (1e-7 absolute error mis-bins
    near-facet points,
    which corrupts derivative tables of macro elements by |D2 jump| *
    tol).  Cancellation happens in the affine map, so the map runs in
    df32; the tiny result then fits f32 exactly (relative encoding)."""
    m, sd = A.shape
    coords = [ff_from_f64(pts[..., i], xp=jnp) for i in range(sd)]
    consts = [[const_ff(np.asarray(A[j, i])) for i in range(sd)]
              for j in range(m)]
    bconsts = [const_ff(np.asarray(b[j])) for j in range(m)]
    total = None
    for j in range(m):
        bj = FF(jnp.broadcast_to(bconsts[j].hi, pts.shape[:-1]),
                jnp.broadcast_to(bconsts[j].lo, pts.shape[:-1]))
        for i in range(sd):
            bj = ff_add(bj, ff_mul_const(consts[j][i], coords[i]))
        neg = bj.hi < 0
        part = FF(jnp.where(neg, -bj.hi, 0.0), jnp.where(neg, -bj.lo, 0.0))
        total = part if total is None else ff_add(total, part)
    return total.hi + total.lo


# ---------------------------------------------------------------------------
# Ozaki slice preparation straight from the pair

def prepare_B_ff(phi_ff, nslices=None):
    """Fixed window slices + pow2 column scales of an FF tabulation --
    drop-in for ops/multiword.py:prepare_B(phi_f64), with every step in
    native f32.

    The window subtractions are exact: each slice s carries the leading
    bits of the running hi word (Sterbenz), and the pair renormalises
    with one TwoSum so lo's bits surface once hi is consumed."""
    from .multiword import CHUNK, DEFAULT_SLICES
    nslices = DEFAULT_SLICES if nslices is None else nslices
    hi, lo = phi_ff
    m = jnp.max(jnp.abs(hi), axis=0, keepdims=True)
    m = jnp.where(m == 0, np.float32(1.0), m)
    sB = jnp.exp2(jnp.ceil(jnp.log2(m)))           # exact power of two
    inv = np.float32(1.0) / sB                     # pow2: exact
    rh, rl = hi * inv, lo * inv
    out = []
    for i in range(nslices):
        scale = np.float32(2.0 ** (CHUNK * (i + 1)))
        s = jnp.round(rh * scale) / scale
        out.append(s.astype(jnp.bfloat16))
        rh, rl = two_sum(rh - s, rl)
    return out, sB
