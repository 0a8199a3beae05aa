#!/usr/bin/env python3
"""Full-zoo DEVICE parity sweep: every simplex Ciarlet/macro instance of
the parity-sweep spec list, tabulated through the device engine
(ops.device_tabulator) and compared against the host float64 tabulation
of the SAME element.

This closes the loop the CPU test suite cannot: the suite proves the
host path against the reference (tests/test_parity_sweep.py), the bench
proves five fixed zoos on device (bench.py); this sweep proves the
device engine across the WHOLE constructible zoo on real hardware.
(Tensor-product/hypercube families tabulate through the symbolic
layer's factored programs instead -- see docs/symbolic.md -- and are
outside the fused simplex engine by design.)

Usage: python tools/device_sweep.py [--npts 4000] [--chunk 24]
Prints one line per engine chunk and a per-family worst-error summary;
exits 1 if any element errs above --atol (default 1e-10).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "shims"))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np


def interior_points(dim, n, seed=23):
    rng = np.random.default_rng((seed, dim))
    b = rng.dirichlet(np.ones(dim + 1), size=n) * 0.9 + 0.1 / (dim + 1)
    return b[:, 1:] / b.sum(axis=1, keepdims=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=24,
                    help="elements per fused engine build")
    ap.add_argument("--atol", type=float, default=1e-10)
    ap.add_argument("--order", type=int, default=1)
    args = ap.parse_args()

    # AlfeldC2's macro change-of-basis matrix carries ~4.4e4 entries that
    # cancel down to O(20) tables (cond ~1e8 C2-constrained space, the
    # same conditioning behind its 2e-9 host-vs-reference bound in
    # tests/test_parity_sweep.py): ~1e-13 RELATIVE accuracy on the
    # intermediates lands at ~3e-9 ABSOLUTE here.
    family_atol = {"AlfeldC2": 5e-9}

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from test_nodality_sweep import SPECS, _build, _label
    from fiat_tpu.ops import device_tabulator

    print("device:", jax.devices()[0], flush=True)

    by_dim = {}
    skipped = []
    for spec in SPECS:
        try:
            e = _build(spec)
        except Exception as exc:
            skipped.append((_label(spec), f"build: {type(exc).__name__}"))
            continue
        cell = e.get_reference_element()
        if not hasattr(cell, "compute_barycentric_coordinates") \
                and cell.get_shape() not in (1, 2, 3):
            pass
        sd = cell.get_spatial_dimension()
        nodal = getattr(e, "is_nodal", lambda: False)()
        macro = e.is_macroelement()
        is_simplex = len(cell.get_topology()[sd]) == 1 and \
            len(cell.get_topology()[0]) == sd + 1
        if sd == 0 or not is_simplex or not (nodal or macro):
            skipped.append((_label(spec), "outside fused simplex engine"))
            continue
        by_dim.setdefault(sd, []).append((spec, e))

    worst = {}
    failures = []
    for sd in sorted(by_dim):
        pts = interior_points(sd, args.npts)
        dpts = jnp.asarray(pts)
        entries = by_dim[sd]
        # anchor each chunk with a plain element (macro-only zoos are
        # rejected by BatchedTabulator) and keep chunks degree-sorted
        entries.sort(key=lambda t: t[1].get_nodal_basis()
                     .get_embedded_degree() if t[1].is_macroelement()
                     is False else t[1].degree())
        from fiat_tpu import elements as fe
        for k0 in range(0, len(entries), args.chunk):
            chunk = entries[k0:k0 + args.chunk]
            zoo = [e for _s, e in chunk]
            anchor = 0
            if all(e.is_macroelement() for e in zoo):
                zoo = [fe.Lagrange(zoo[0].get_reference_element(), 1)] + zoo
                anchor = 1
            try:
                bt = device_tabulator(zoo, order=args.order)
                per = bt.unpack({a: np.asarray(t)
                                 for a, t in bt(dpts).items()})
            except Exception as exc:
                for s, _e in chunk:
                    failures.append((_label(s),
                                     f"engine: {type(exc).__name__}: "
                                     f"{str(exc)[:80]}"))
                continue
            for (spec, e), tab in zip(chunk, per[anchor:]):
                host = e.tabulate(args.order, pts)
                err = 0.0
                for a in host:
                    mine = np.asarray(tab[a]).reshape(np.shape(host[a]))
                    err = max(err, float(np.abs(mine
                                                - np.asarray(host[a])).max()))
                lab = _label(spec)
                fam = spec[0]
                worst[fam] = max(worst.get(fam, 0.0), err)
                if err > family_atol.get(fam, args.atol):
                    failures.append((lab, f"err {err:.2e}"))
            print("dim %d chunk %2d: %2d elements checked" %
                  (sd, k0 // args.chunk, len(chunk)), flush=True)

    print("\nper-family worst |engine - host f64| (%d families):"
          % len(worst))
    for fam in sorted(worst, key=worst.get, reverse=True):
        print("  %-28s %.2e" % (fam, worst[fam]))
    print("\n%d specs outside the fused simplex engine (TP/hypercube/"
          "non-nodal: symbolic-layer path)" % len(skipped))
    if failures:
        print("\nFAILURES (%d):" % len(failures))
        for lab, why in failures:
            print("  %-40s %s" % (lab, why))
        return 1
    print("\nDEVICE SWEEP OK: every engine-covered instance <= %.0e "
          "(documented family bounds: %s)" % (args.atol, family_atol))
    return 0


if __name__ == "__main__":
    sys.exit(main())
