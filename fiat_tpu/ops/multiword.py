"""f64-accurate matmul from bf16 products via Ozaki-style multiword splitting.

The change-of-basis GEMMs of the emulated f64 engine ("ozaki",
ops.f64_engine), for platforms whose matrix units have no f64.  This
module implements the Ozaki split scheme (Ozaki, Ogita, Oishi & Rump
2012):

* rows of A and columns of B are scaled by powers of two into [1/2, 1);
* each scaled operand is sliced at FIXED 8-bit windows:
  x = x_0 + x_1 + ..., x_i = round(r * 2^{8(i+1)}) / 2^{8(i+1)} --
  every slice is an integer multiple of its window and carries <= 8
  significand bits, so it is exactly representable in bf16 and every
  pairwise slice product (16-bit integer at a known scale) accumulates
  EXACTLY in an f32 accumulator for K up to 2^8;
* slice products are grouped by total order t = i + j; each group is
  ONE bf16 matmul (slices concatenated along the contraction axis);
* the groups are summed in f64 and unscaled.

Groups t <= ORDER keep ~8*(ORDER+2) product bits: ORDER=5 keeps ~56
(~3e-14 relative measured), comfortably inside the framework's 1e-10
reproduction budget, at the cost of 4 batched bf16 matmuls instead of
one emulated-f64 matmul."""

import numpy as np
import jax
import jax.numpy as jnp

#: bits per slice window: 8-bit windows are still exact in bf16 (any
#: k/2^8 with |k| <= 2^8 has <= 8 significand bits) and their 16-bit
#: pairwise products accumulate exactly in an f32 accumulator for
#: contraction lengths up to 2^(24-16) = 256 (longer contractions chunk)
CHUNK = 8
#: keep product groups with i + j <= DEFAULT_ORDER (~8 bits per order:
#: order 5 keeps ~56 product bits, measured ~3e-14 relative)
DEFAULT_ORDER = 5
#: slices per operand: slice i only ever multiplies slices j <= order-i,
#: so indices past the order are dead weight in every group -- computing
#: or streaming them changes nothing (order+1 slices carry 49 of an
#: operand's bits; bits below that scale cannot reach any kept product)
DEFAULT_SLICES = DEFAULT_ORDER + 1


def _pow2_scale(x, axis, xp=jnp):
    """Per-row/column power-of-two scale putting max|x| in [1/2, 1)."""
    m = xp.max(xp.abs(x), axis=axis, keepdims=True)
    m = xp.where(m == 0, 1.0, m)
    e = xp.ceil(xp.log2(m))
    return xp.exp2(e)


def _fixed_window_slices(x, nslices, xp=jnp):
    """Slice |x| <= 1 at fixed CHUNK-bit windows; returns bf16 slices."""
    out = []
    r = x
    for i in range(nslices):
        scale = float(2.0 ** (CHUNK * (i + 1)))
        s = xp.round(r * scale) / scale
        out.append(s.astype(jnp.bfloat16) if xp is jnp else s)
        r = r - s
    return out


def split_scaled_host(A, nslices=DEFAULT_SLICES):
    """Host-side preparation of A: (window slices of scaled A, row
    scale)."""
    import ml_dtypes
    A = np.asarray(A, dtype=np.float64)
    sA = np.asarray(_pow2_scale(A, axis=1, xp=np))
    slices = _fixed_window_slices(A / sA, nslices, xp=np)
    return [s.astype(ml_dtypes.bfloat16) for s in slices], sA


def prepare_B(B, nslices=DEFAULT_SLICES):
    """Device-side split of the right operand, shareable across many
    left operands: (window slices, column scales)."""
    sB = _pow2_scale(B, axis=0)
    return _fixed_window_slices(B / sB, nslices), sB


def matmul_f64_ozaki(A_slices, sA, B, nslices=DEFAULT_SLICES,
                     order=DEFAULT_ORDER, B_prepared=None, share=False):
    """A @ B in near-f64 accuracy with A pre-split host-side.

    :arg A_slices: bf16 slices [R, K] of the row-scaled A
    :arg sA: f64 row scales [R, 1]
    :arg B: f64 [K, P] (scaled and split on device), or None with
        ``B_prepared`` from :func:`prepare_B`
    :returns: f64 [R, P] with ~8*(order+2) accurate product bits."""
    if B_prepared is None:
        B_prepared = prepare_B(B, nslices)
    B_slices, sB = B_prepared

    # group-0 accumulation is exact only while 16-bit slice products fit
    # the 24-bit f32 accumulator (K <= 256), and the shared t>=1 batches
    # accumulate mixed-scale products whose rounding grows with K: split
    # longer contractions into 256-chunks and sum the partials in f64
    K = A_slices[0].shape[1]
    if K > 256:
        # long contractions also de-share the order groups (share=False):
        # backends that accumulate sequentially (CPU oracle) round the
        # mixed-scale shared batches at every step
        total = 0.0
        for k0 in range(0, K, 256):
            ksl = slice(k0, k0 + 256)
            total = total + matmul_f64_ozaki(
                [a[:, ksl] for a in A_slices], 1.0, None, nslices, order,
                B_prepared=([b[ksl] for b in B_slices], 1.0), share=False)
        return total * (jnp.asarray(sA) * sB)

    # one dot per order group: same-scale products accumulate EXACTLY
    # (16-bit integers at one quantum; <= 2^24 quanta for K <= 256).
    # Sharing adjacent groups in one accumulation was a 7-bit-era
    # optimisation: with 8-bit windows the mixed-scale rounding costs
    # ~2e-9 (measured), so it is no longer offered by default.
    if share:
        batches = [(0,)] + [tuple(t for t in pair if t <= order)
                            for pair in ((1, 2), (3, 4), (5, 6), (7, 8))]
    else:
        batches = [(t,) for t in range(order + 1)]
    groups = []
    for ts in batches:
        idx = [(i, t - i) for t in ts for i in range(t + 1)
               if i < len(A_slices) and t - i < len(B_slices)]
        if not idx:
            continue
        Acat = jnp.concatenate([A_slices[i] for i, _ in idx], axis=1)
        Bcat = jnp.concatenate([B_slices[j] for _, j in idx], axis=0)
        groups.append(jax.lax.dot(Acat, Bcat,
                                  preferred_element_type=jnp.float32))
    # two-float (TwoSum) accumulation of the group results in f32:
    # the running error term carries the bits below the f32 sum, so
    # only ONE emulated-f64 add (hi+lo) and one f64 multiply (unscale)
    # remain per element -- the f64 combine was ~40% of the whole pass
    s = groups[0]                        # largest group first
    e = jnp.zeros_like(s)
    for g in groups[1:]:
        t = s + g
        bp = t - s
        e = e + ((s - (t - bp)) + (g - bp))   # Knuth TwoSum error
        s = t
    total = s.astype(jnp.float64) + e.astype(jnp.float64)
    return total * (jnp.asarray(sA) * sB)


class MultiwordMatmul:
    """Precomputed-A multiword matmul: ``mm = MultiwordMatmul(A);
    C = mm(B)`` with f64-level accuracy from bf16 products."""

    def __init__(self, A, nslices=DEFAULT_SLICES, order=DEFAULT_ORDER):
        self.shape = A.shape
        self.nslices = nslices
        self.order = order
        slices, sA = split_scaled_host(A, nslices)
        self.A_slices = [jnp.asarray(s) for s in slices]
        self.sA = sA

    def __call__(self, B):
        return matmul_f64_ozaki(self.A_slices, self.sA, B,
                                self.nslices, self.order)

    def apply(self, B_prepared):
        """Apply against a pre-split right operand (share the split of
        one B across many left matrices)."""
        return matmul_f64_ozaki(self.A_slices, self.sA, None,
                                self.nslices, self.order,
                                B_prepared=B_prepared)
