#!/usr/bin/env python3
"""Smoke test of the device engine on one NVIDIA GPU.

Drives the library's main path through its public entry points at the
width of the deployment-sized triangle zoo (42 elements, 1392 basis
rows) and checks it against the host f64 tabulation, in phases:

1. device: JAX must see a GPU; the card, versions and flags are printed.
2. tabulation: ``ops.device_tabulator(zoo, order=1)`` at 1e5 points
   (f64 values and both gradients); 2,000 point columns are checked
   against ``el.tabulate`` to 1e-10 max abs, every table for finiteness.
   The f32 engine is checked against the same columns.
3. moments: ``ops.moments.zoo_moments`` and ``interpolate_rows`` against
   a host f64 contraction at 2e4 points (1e-12 relative), then at 1e6.
4. engines: the native and the Ozaki f64 engines timed at those sizes,
   beside the floors the card's memory bandwidth sets.
5. gpu tests: the test suite's cases marked ``gpu``.

``--devices N`` runs only the sharded path of docs/parallel.md on an
N-card mesh (1-D over points, and 2 x N/2 for the 2-D moment step),
each step against the single-card result to 1e-12.

Usage:  python chip_smoke.py [--devices 4]

The last line of standard output is one JSON object with "ok": true.
Any failed phase exits non-zero and prints no such line; so does a run
in which JAX finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

NPTS_TAB = 100_000        # tabulation points: 1392 x 3 x 1e5 x 8 B = 3.3 GB
NPTS_MOM = 1_000_000      # quadrature points of a ~1e5-cell mesh
NCHECK_TAB = 2_000        # point columns checked against the host tables
NCHECK_MOM = 20_000       # points of the host moment/interpolation oracle
REPS = 5                  # timed repetitions after the warm-up call

#: f64 tables: the repo's parity budget (max abs against the host tables)
TAB_ATOL = 1e-10
#: f64 moments and point values, relative to the largest entry: the sums
#: run over the points in another order than the host's, nothing more
MOM_RTOL = 1e-12
#: f32 tables, relative to the largest host entry of each table: f32
#: tables and change of basis of the degree-10 zoo, 1.1e-6 on the H100
#: and on the CPU (which has no TF32), with a factor 10 of room; a dot
#: computed in TF32 (~1e-3 relative) misses it by two orders
F32_RTOL = 1e-5
#: sharded against single-card results: the same arithmetic, with the
#: point reductions split across the cards
SHARD_RTOL = 1e-12


class PhaseFailed(Exception):
    """A check of a phase did not hold."""


def log(*args):
    print(*args, flush=True)


def check(name, err, tol):
    """Raise PhaseFailed unless ``err <= tol`` (NaN fails)."""
    if not err <= tol:
        raise PhaseFailed(f"{name}: error {err:.3e} exceeds {tol:.0e}")
    log(f"  {name}: {err:.3e} (bound {tol:.0e})")


def full_zoo():
    """The 42-element triangle zoo: Lagrange 1-10, DG 1-8, RT, N1curl and
    BDM 1-6, Hermite, Morley, Argyris 5, Bell, HCT 3 and PS6."""
    from fiat_tpu import elements as fe
    from fiat_tpu.core.cells import ufc_simplex
    tri = ufc_simplex(2)
    return ([fe.Lagrange(tri, p) for p in range(1, 11)]
            + [fe.DiscontinuousLagrange(tri, p) for p in range(1, 9)]
            + [fe.RaviartThomas(tri, k) for k in range(1, 7)]
            + [fe.Nedelec(tri, k) for k in range(1, 7)]
            + [fe.BrezziDouglasMarini(tri, k) for k in range(1, 7)]
            + [fe.CubicHermite(tri), fe.Morley(tri), fe.Argyris(tri, 5),
               fe.Bell(tri), fe.HsiehCloughTocher(tri, 3),
               fe.QuadraticPowellSabin6(tri)])


def triangle_points(n, seed):
    """n random points in the reference triangle."""
    rng = np.random.default_rng(seed)
    p = rng.random((n, 2))
    return p / (p.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def table_error(per_element, zoo, pts, order, relative=False):
    """Largest |device - host| over the zoo's elements and derivative
    tables, against the host f64 ``el.tabulate``; ``relative`` divides
    each table's error by its largest host entry."""
    worst = 0.0
    for el, mine in zip(zoo, per_element):
        for alpha, want in el.tabulate(order, pts).items():
            want = np.asarray(want)
            got = np.asarray(mine[alpha], np.float64).reshape(want.shape)
            err = float(np.abs(got - want).max())
            if relative:
                err /= max(float(np.abs(want).max()), 1e-300)
            worst = max(worst, err)
    return worst


def rel_error(got, want):
    """max |got - want| over max |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def timed(fn, *args, reps=REPS):
    """Seconds of the first call (compilation included) and the median
    and least of ``reps`` further calls, each ended by block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"first_s": first, "median_s": float(np.median(times)),
            "min_s": min(times)}


def all_finite(tables):
    import jax.numpy as jnp
    return all(bool(jnp.isfinite(t).all()) for t in tables)


class Smoke:
    """One smoke run: a zoo, its point sets and host oracles, at given
    sizes.  Each phase method raises PhaseFailed when a check fails and
    records what it measured in ``results``."""

    def __init__(self, zoo, npts_tab=NPTS_TAB, npts_mom=NPTS_MOM,
                 ncheck_tab=NCHECK_TAB, ncheck_mom=NCHECK_MOM, reps=REPS):
        self.zoo = zoo
        self.ncheck_tab = ncheck_tab
        self.ncheck_mom = ncheck_mom
        self.reps = reps
        self.pts_tab = triangle_points(npts_tab, seed=42)
        self.pts_mom = triangle_points(npts_mom, seed=7)
        rng = np.random.default_rng(11)
        self.weights = rng.random(npts_mom) / npts_mom
        self.field = np.cos(3 * self.pts_mom[:, 0]) * (1 + self.pts_mom[:, 1])
        self.rows = sum(el.space_dimension()
                        * int(np.prod(el.value_shape() or (1,)))
                        for el in zoo)
        self.coeffs = rng.random(self.rows) - 0.5
        self.results = {}
        self._tabulators = {}
        self._host_rows = None

    # -- shared pieces --------------------------------------------------
    def tabulator(self, order, matmul, dtype=None):
        """One BatchedTabulator per configuration, so a phase that times
        an engine reuses what an earlier phase compiled."""
        from fiat_tpu.ops.tabulate import BatchedTabulator
        key = (order, matmul, dtype)
        if key not in self._tabulators:
            self._tabulators[key] = BatchedTabulator(
                self.zoo, order=order, matmul=matmul, dtype=dtype)
        return self._tabulators[key]

    def host_rows(self):
        """(rows, ncheck_mom) host f64 value table in the fused layout."""
        if self._host_rows is None:
            pts = self.pts_mom[:self.ncheck_mom]
            self._host_rows = np.concatenate([
                np.asarray(el.tabulate(0, pts)[(0, 0)]).reshape(-1, len(pts))
                for el in self.zoo])
        return self._host_rows

    def check_tables(self, tab, order, relative=False):
        """Tabulate ``pts_tab``; check shapes and finiteness of every
        table; return the error of the first ncheck_tab columns against
        the host (``table_error``)."""
        import jax.numpy as jnp
        tables = tab(jnp.asarray(self.pts_tab))
        npts = len(self.pts_tab)
        for alpha, t in tables.items():
            if t.shape != (self.rows, npts):
                raise PhaseFailed(f"table {alpha}: shape {t.shape}, "
                                  f"expected {(self.rows, npts)}")
        if not all_finite(tables.values()):
            raise PhaseFailed("a table holds a non-finite value")
        cols = {a: np.asarray(t[:, :self.ncheck_tab])
                for a, t in tables.items()}
        return table_error(tab.unpack(cols), self.zoo,
                           self.pts_tab[:self.ncheck_tab], order, relative)

    def moment_fns(self, bt):
        import jax
        from fiat_tpu.ops.moments import interpolate_rows, zoo_moments
        return (lambda p, w, f: zoo_moments(bt, p, w, f),
                jax.jit(lambda p, c: interpolate_rows(bt, p, c)))

    # -- phases ---------------------------------------------------------
    def tabulation(self):
        """Phase 2: device_tabulator's f64 and f32 tables."""
        import jax.numpy as jnp
        from fiat_tpu.ops import device_tabulator
        tab = device_tabulator(self.zoo, order=1)
        self._tabulators[(1, tab.matmul, jnp.float64)] = tab
        log(f"  engine {tab.matmul}: {len(self.zoo)} elements, "
            f"{self.rows} rows, {len(self.pts_tab)} points")
        err = self.check_tables(tab, 1)
        check("f64 tables vs host, max abs", err, TAB_ATOL)
        tab32 = device_tabulator(self.zoo, order=1, f64=False)
        err32 = self.check_tables(tab32, 1, relative=True)
        check("f32 tables vs host, max relative", err32, F32_RTOL)
        self.results["tabulation"] = {"engine": tab.matmul,
                                      "f64_max_abs_err": err,
                                      "f32_max_rel_err": err32}

    def moments(self):
        """Phase 3: moments and point values, checked, then at scale."""
        import jax.numpy as jnp
        from fiat_tpu.ops import device_tabulator
        bt = device_tabulator(self.zoo, order=0)
        self._tabulators[(0, bt.matmul, jnp.float64)] = bt
        moments, interp = self.moment_fns(bt)
        n = self.ncheck_mom
        pts, w, f = (jnp.asarray(self.pts_mom[:n]),
                     jnp.asarray(self.weights[:n]),
                     jnp.asarray(self.field[:n]))
        host = self.host_rows()
        m = moments(pts, w, f)
        m_err = rel_error(m, host @ (self.weights[:n] * self.field[:n]))
        check("moments vs host, max relative", m_err, MOM_RTOL)
        u_err = rel_error(interp(pts, jnp.asarray(self.coeffs)),
                          self.coeffs @ host)
        check("point values vs host, max relative", u_err, MOM_RTOL)
        big = jnp.asarray(self.pts_mom)
        m = moments(big, jnp.asarray(self.weights), jnp.asarray(self.field))
        u = interp(big, jnp.asarray(self.coeffs))
        if m.shape != (self.rows,) or u.shape != (len(self.pts_mom),):
            raise PhaseFailed(f"shapes {m.shape}, {u.shape}")
        if not all_finite([m, u]):
            raise PhaseFailed("moments or point values not finite")
        log(f"  {len(self.pts_mom)} points: moments and point values finite")
        self.results["moments"] = {"moments_max_rel_err": m_err,
                                   "interp_max_rel_err": u_err}

    def engines(self, peaks, card):
        """Phase 4: native and Ozaki engines, timed and checked on
        ``card`` (its nvidia-smi name and power limit)."""
        import jax.numpy as jnp
        log(f"  timing on {card}")
        out = {"card": card}
        dpts = jnp.asarray(self.pts_tab)
        big = (jnp.asarray(self.pts_mom), jnp.asarray(self.weights),
               jnp.asarray(self.field))
        n = self.ncheck_mom
        host = self.host_rows()
        for engine in ("native", "ozaki"):
            tab = self.tabulator(1, engine, jnp.float64)
            rec = {"df32": bool(tab._ff_ok),
                   "tabulate": timed(tab, dpts, reps=self.reps),
                   "tabulate_max_abs_err": self.check_tables(tab, 1)}
            moments, interp = self.moment_fns(
                self.tabulator(0, engine, jnp.float64))
            rec["moments"] = timed(moments, *big, reps=self.reps)
            rec["interpolate"] = timed(interp, big[0],
                                       jnp.asarray(self.coeffs),
                                       reps=self.reps)
            small = jnp.asarray(self.pts_mom[:n])
            rec["moments_max_rel_err"] = rel_error(
                moments(small, big[1][:n], big[2][:n]),
                host @ (self.weights[:n] * self.field[:n]))
            rec["interp_max_rel_err"] = rel_error(
                interp(small, jnp.asarray(self.coeffs)), self.coeffs @ host)
            out[engine] = rec
            log(f"  {engine}: " + json.dumps(rec))
        hbm = peaks["hbm_bytes_s"]
        npts, nmom = len(self.pts_tab), len(self.pts_mom)
        out["floors_s"] = {
            # every f64 table written once: values and two gradients
            "tabulate": self.rows * 3 * npts * 8 / hbm,
            # the points and the weighted integrand read once
            "moments": nmom * 3 * 8 / hbm,
            # the points read and the values written once
            "interpolate": nmom * 3 * 8 / hbm}
        log("  floors: " + json.dumps(out["floors_s"]))
        self.results["engines"] = out

    def sharded(self, n_devices):
        """--devices: the sharded steps against single-card results."""
        import jax
        import jax.numpy as jnp
        from fiat_tpu.ops import device_tabulator
        from fiat_tpu.parallel.sharding import (make_interpolation_step,
                                                make_moment_step,
                                                make_moment_step_2d,
                                                points_mesh, shard_points,
                                                sharded_tabulate, zoo_mesh)
        if jax.device_count() < n_devices or n_devices % 2:
            raise PhaseFailed(f"--devices {n_devices}: JAX sees "
                              f"{jax.device_count()} devices; an even "
                              f"count it has is needed")
        mesh = points_mesh(n_devices)
        out = {}
        tab = device_tabulator(self.zoo, order=1)
        single = {a: np.asarray(t)
                  for a, t in tab(jnp.asarray(self.pts_tab)).items()}
        sharded = sharded_tabulate(tab, self.pts_tab, mesh)
        out["tabulate_rel_err"] = max(
            rel_error(sharded[a], single[a]) for a in single)
        del single, sharded
        check("sharded tables vs one card", out["tabulate_rel_err"],
              SHARD_RTOL)

        bt = device_tabulator(self.zoo, order=0)
        moments, interp = self.moment_fns(bt)
        pts, w, f = (jnp.asarray(self.pts_mom), jnp.asarray(self.weights),
                     jnp.asarray(self.field))
        c = jnp.asarray(self.coeffs)
        m1, u1 = np.asarray(moments(pts, w, f)), np.asarray(interp(pts, c))
        spec = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("points"))
        spts = shard_points(pts, mesh)
        sw, sf = jax.device_put(w, spec), jax.device_put(f, spec)
        step = make_moment_step(bt, mesh)
        out["moments_rel_err"] = rel_error(step(spts, sw, sf), m1)
        out["moment_step"] = timed(step, spts, sw, sf, reps=self.reps)
        check("moment step vs one card", out["moments_rel_err"], SHARD_RTOL)
        istep = make_interpolation_step(bt, mesh)
        out["interp_rel_err"] = rel_error(istep(spts, c), u1)
        out["interpolation_step"] = timed(istep, spts, c, reps=self.reps)
        check("interpolation step vs one card", out["interp_rel_err"],
              SHARD_RTOL)
        mesh2 = zoo_mesh(n_points=n_devices // 2, n_rows=2)
        step2 = make_moment_step_2d(bt, mesh2)
        m2 = np.asarray(step2(pts, w, f))
        out["moments_2d_rel_err"] = rel_error(m2[:self.rows], m1)
        out["moment_step_2d"] = timed(step2, pts, w, f, reps=self.reps)
        check("2-D moment step vs one card", out["moments_2d_rel_err"],
              SHARD_RTOL)
        log("  " + json.dumps(out))
        self.results["sharded"] = out


def gpu_tests():
    """Phase 5: the test suite's cases marked ``gpu``, in this process
    (the card is already held here)."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise PhaseFailed(f"gpu tests exited {rc}")


def run_phases(phases, device):
    """Run ``(name, callable)`` phases in order.  The first failure
    prints its traceback and returns 1; after the last, the ok line is
    printed as the last line of standard output and 0 returned."""
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            log(f"phase {name} FAILED")
            return 1
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="run only the sharded path on this many cards")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fiat_tpu.utils.runtime import enable_compilation_cache
    from bench import device_peaks
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    for line in smi.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"device_kind: {dev.device_kind}; devices: {jax.device_count()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}

    smoke = Smoke(full_zoo())
    if args.devices:
        phases = [("sharded", lambda: smoke.sharded(args.devices))]
    else:
        phases = [("tabulation", smoke.tabulation),
                  ("moments", smoke.moments),
                  ("engines", lambda: smoke.engines(
                      device_peaks(dev.device_kind), smi.strip())),
                  ("gpu tests", gpu_tests)]

    def record():
        out = os.path.join(REPO, "chiprun_out", "chip_smoke.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"card": smi.strip(), "device": device,
                       "results": smoke.results}, fh, indent=1)
    return run_phases(phases + [("record", record)], device)


if __name__ == "__main__":
    sys.exit(main())
