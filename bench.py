"""Benchmark of the device engine on one NVIDIA GPU.

Nine configurations, each timed on the card and checked against the
host f64 tabulation of the same elements (``el.tabulate``, plain NumPy),
which is also timed as the single-threaded baseline:

  p2_tri_deg4rule    P2 Lagrange/triangle at the degree-4 Gauss-Jacobi
                     rule, tiled to 1e5 points (assembly over ~17k cells)
  tet_lagrange8      order-8 Lagrange/tet at 1e5 points
  hex_gll_sumfact    order-8 GLL hex: sum-factorised moments on a 46^3
                     factored grid
  hdiv_hcurl_tri/tet RT / Nedelec / BDM on triangles (k<=6), tets (k<=3)
  c1_macro_zoo       C1 zoo: Hermite, Morley, Argyris, Bell + HCT and
                     Powell-Sabin 6/12 macro side programs
  c1_macro_hessians  the same at order 2
  full_zoo           the full triangle sweep (Lagrange p<=10, DG p<=8,
                     RT/Ned/BDM k<=6, Hermite, Morley, Argyris, Bell, HCT,
                     PS6), values + gradients
  moments_interp_full_zoo  moments of the full zoo, expansion-side

Every timing is the median of host-clock runs ended by
``block_until_ready``, after a warm-up call.  The full record is written
to chiprun_out/bench.json; the last line of standard output is a compact
per-config summary.  A config that fails ends the run with a non-zero
exit code.  Usage: ``python bench.py`` (on the card).
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

NPTS = 100_000
NREF = 20_000   # host baseline points (scaled linearly to NPTS)
NCHECK = 2_000
REPS = 5

#: Published dense peaks of the cards the benchmark knows, keyed by JAX's
#: ``device_kind``: NVIDIA H100 data sheet, SXM part, at its 700 W limit
#: (HBM3 bandwidth; f64 on the tensor cores and outside them; f32 outside
#: the tensor cores; dense bf16 on the tensor cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12,
                              "f64_tensor_flops_s": 67e12,
                              "f64_flops_s": 34e12,
                              "f32_flops_s": 67e12,
                              "bf16_flops_s": 989e12},
}


def device_peaks(kind):
    """The PEAKS entry of a device kind; an unknown device is an error."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def device_timer(jax, fn, *args):
    """Median seconds of one blocking fn(*args), after a warm-up call
    (compilation excluded)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def host_timer(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def roofline(seconds, flops, bytes_moved, peaks):
    """Least time the card could take (f64 tensor-core rate, HBM) and the
    share of it the measured time reaches."""
    terms = {"f64": flops / peaks["f64_tensor_flops_s"],
             "hbm": bytes_moved / peaks["hbm_bytes_s"]}
    bound = max(terms, key=terms.get)
    return {"flops": flops, "bytes": bytes_moved, "bound": bound,
            "floor_ms": terms[bound] * 1e3, "share": terms[bound] / seconds}


def zoo_config(jax, jnp, peaks, name, zoo, pts, order=1, nref=NREF):
    """Time the fused f64 tables of a zoo on the card against the host
    tabulation of the same elements."""
    from fiat_tpu.ops import device_tabulator
    bt = device_tabulator(zoo, order=order)
    dpts = jnp.asarray(pts)
    sys.stderr.write(f"[bench] {name}: compiling and timing\n")
    seconds = device_timer(jax, bt, dpts)
    rows = max(hi for (lo, hi, shape) in bt.slices)
    ntab = len(bt._alpha_order) if bt.alpha_mats else 1
    work = rows * len(pts) * ntab

    sub = pts[:NCHECK]
    per = bt.unpack({a: np.asarray(t) for a, t in bt(sub).items()})
    max_err = 0.0
    for e, tab in zip(zoo, per):
        for a, want in e.tabulate(order, sub).items():
            max_err = max(max_err, float(np.abs(
                np.asarray(want) - tab[a].reshape(np.shape(want))).max()))
    rpts = pts[:nref]
    ref_s = host_timer(lambda: [e.tabulate(order, rpts) for e in zoo])
    ref_s *= len(pts) / len(rpts)
    return {"name": name, "elements": len(zoo), "rows": rows,
            "device_ms": seconds * 1e3, "ref_s": ref_s,
            "speedup": ref_s / seconds, "max_abs_err": max_err,
            "work": work, "values_per_s": work / seconds,
            "roofline": roofline(seconds, bt.flop_count(len(pts)),
                                 work * 8, peaks)}


def moments_config(jax, jnp, peaks, name, zoo, pts, nref=NREF):
    """Moments M[i] = sum_q w_q f(x_q) phi_i(x_q) of every basis function
    of the zoo, computed expansion-side (ops/moments.py: the nodal table
    is never built); ``via_tables_ms`` times materialising the table
    and contracting it instead."""
    from fiat_tpu.ops import device_tabulator
    from fiat_tpu.ops import moments as mo
    bt = device_tabulator(zoo, order=0)
    rng = np.random.default_rng(7)
    wf_h = rng.random(len(pts))
    dpts, wf = jnp.asarray(pts), jnp.asarray(wf_h)
    sys.stderr.write(f"[bench] {name}: compiling and timing\n")
    moments = jax.jit(lambda q, w: mo.moment_rows(bt, q, w))
    seconds = device_timer(jax, moments, dpts, wf)
    via_tables = device_timer(
        jax, jax.jit(lambda q, w: bt._tabulate(q)[(0, 0)] @ w), dpts, wf)
    rows = max(hi for (lo, hi, shape) in bt.slices)

    sub, wsub = pts[:NCHECK], wf_h[:NCHECK]
    per = mo.unpack_moments(bt, moments(jnp.asarray(sub), jnp.asarray(wsub)))
    max_err = 0.0
    for e, m in zip(zoo, per):
        tab = np.asarray(e.tabulate(0, sub)[(0,) * sub.shape[1]])
        want = tab.reshape(m.shape + (len(sub),)) @ wsub
        max_err = max(max_err, float(np.abs(want - m).max()))
    rpts, rw = pts[:nref], wf_h[:nref]
    ref_s = host_timer(lambda: [
        np.asarray(e.tabulate(0, rpts)[(0,) * rpts.shape[1]]).reshape(
            -1, len(rpts)) @ rw for e in zoo]) * len(pts) / len(rpts)
    nexp = bt.stacked.shape[1]
    return {"name": name, "elements": len(zoo), "rows": rows,
            "device_ms": seconds * 1e3, "via_tables_ms": via_tables * 1e3,
            "ref_s": ref_s, "speedup": ref_s / seconds,
            "max_abs_err": max_err, "work": rows * len(pts),
            "values_per_s": rows * len(pts) / seconds,
            "roofline": roofline(seconds, 2 * nexp * len(pts),
                                 len(pts) * 3 * 8, peaks)}


def hex_gll_config(jax, jnp, peaks):
    """Order-8 GLL hex: sum-factorised moments on a 46^3 factored grid,
    checked against the same contraction on the host."""
    from fiat_tpu import elements as fe
    from fiat_tpu.core import cells as cl
    from fiat_tpu.core.quadrature import GaussJacobiQuadratureLineRule

    interval = cl.ufc_simplex(1)
    gll = fe.GaussLobattoLegendre(interval, 8)
    m = 46
    rule = GaussJacobiQuadratureLineRule(interval, m)
    x1, w1 = rule.get_points(), rule.get_weights()
    phi1 = np.asarray(gll.tabulate(0, x1)[(0,)])          # (9, m) factor
    pw = phi1 * np.asarray(w1)
    F = np.random.default_rng(0).random((m, m, m))

    def moments(P, f, xp):
        # sum-factorised: contract one axis at a time, O(p*N) per axis
        t = xp.einsum("aq,qrs->ars", P, f)
        t = xp.einsum("br,ars->abs", P, t)
        return xp.einsum("cs,abs->abc", P, t)

    P, dF = jnp.asarray(pw), jnp.asarray(F)
    jm = jax.jit(lambda f: moments(P, f, jnp))
    seconds = device_timer(jax, jm, dF)
    want = moments(pw, F, np)
    max_err = float(np.abs(np.asarray(jm(dF)) - want).max()
                    / np.abs(want).max())
    ref_s = host_timer(lambda: moments(pw, F, np))
    flops = 2 * 9 * m ** 3 + 2 * 81 * m ** 2 + 2 * 729 * m
    return {"name": "hex_gll_sumfact", "device_ms": seconds * 1e3,
            "ref_s": ref_s, "speedup": ref_s / seconds,
            "max_abs_err": max_err, "npts": m ** 3,
            "roofline": roofline(seconds, flops, m ** 3 * 8, peaks)}


def triangle_points(rng, n, sd):
    p = rng.random((n, sd))
    return p / (p.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from fiat_tpu.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)

    from fiat_tpu import elements as fe
    from fiat_tpu.core import cells as cl
    from fiat_tpu.core.quadrature_schemes import create_quadrature

    tri, tet = cl.ufc_simplex(2), cl.ufc_simplex(3)
    rng = np.random.default_rng(42)
    pts2 = triangle_points(rng, NPTS, 2)
    pts3 = triangle_points(rng, NPTS, 3)
    q4 = create_quadrature(tri, 4).get_points()
    tiled = np.tile(q4, (NPTS // len(q4) + 1, 1))[:NPTS]

    def c1_zoo():
        return [fe.CubicHermite(tri), fe.Morley(tri), fe.Argyris(tri, 5),
                fe.Bell(tri), fe.HsiehCloughTocher(tri, 3),
                fe.QuadraticPowellSabin6(tri),
                fe.QuadraticPowellSabin12(tri)]

    def vector_zoo(cell, kmax):
        return [cls(cell, k) for cls in (fe.RaviartThomas, fe.Nedelec,
                                         fe.BrezziDouglasMarini)
                for k in range(1, kmax + 1)]

    def full_zoo():
        return ([fe.Lagrange(tri, p) for p in range(1, 11)]
                + [fe.DiscontinuousLagrange(tri, p) for p in range(1, 9)]
                + vector_zoo(tri, 6)
                + [fe.CubicHermite(tri), fe.Morley(tri), fe.Argyris(tri, 5),
                   fe.Bell(tri), fe.HsiehCloughTocher(tri, 3),
                   fe.QuadraticPowellSabin6(tri)])

    args = (jax, jnp, peaks)
    configs = [
        zoo_config(*args, "p2_tri_deg4rule", [fe.Lagrange(tri, 2)], tiled),
        zoo_config(*args, "tet_lagrange8", [fe.Lagrange(tet, 8)], pts3,
                   nref=2000),
        hex_gll_config(*args),
        zoo_config(*args, "hdiv_hcurl_tri", vector_zoo(tri, 6), pts2),
        zoo_config(*args, "hdiv_hcurl_tet", vector_zoo(tet, 3), pts3,
                   nref=2000),
        zoo_config(*args, "c1_macro_zoo", c1_zoo(), pts2),
        zoo_config(*args, "c1_macro_hessians", c1_zoo(), pts2, order=2),
        zoo_config(*args, "full_zoo", full_zoo(), pts2),
        moments_config(*args, "moments_interp_full_zoo", full_zoo(), pts2),
    ]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    out = os.path.join(REPO, "chiprun_out", "bench.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": device, "configs": configs}, fh, indent=1)
    print(json.dumps({"device": device, "device_ms": {
        c["name"]: round(c["device_ms"], 4) for c in configs},
        "max_abs_err": {c["name"]: c["max_abs_err"] for c in configs}}))


if __name__ == "__main__":
    main()
