"""End-to-end example: integral moments and field interpolation on
device, the two dual-evaluation directions of the engine.

The tabulation engine's physical floor is the 8 B/value write of the
nodal table; consumers that only INTEGRATE against the basis (the
reference's to_riesz / dual_evaluation hot path,
FIAT/dual_set.py:86-206 and finat/finiteelementbase.py:245-285) never
need that table:

1. ``moments``: M[i] = sum_q w_q f(x_q) phi_i(x_q) for every basis
   function of a mixed zoo (macro elements included) -- the expansion
   contracted against the weighted integrand first, then one nexp-vector
   folded through the nodal change of basis
   (fiat_tpu.ops.moments.zoo_moments);
2. ``interpolation``: u(x_q) = sum_i c_i phi_i(x_q) -- the transpose,
   with the coefficients folded through the nodal change of basis
   first (fiat_tpu.ops.moments.interpolate_rows);
3. the roundtrip sanity: interpolating the moment vector of a
   polynomial reproduces the L2-projection values.

Run: python examples/moments_interpolation.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from fiat_tpu.core import cells as cl  # noqa: E402
from fiat_tpu.core.quadrature_schemes import create_quadrature  # noqa: E402
from fiat_tpu import elements as fe  # noqa: E402
from fiat_tpu.ops.tabulate import BatchedTabulator  # noqa: E402
from fiat_tpu.ops import moments as mo  # noqa: E402


def main():
    tri = cl.ufc_simplex(2)
    zoo = [fe.Lagrange(tri, 3), fe.RaviartThomas(tri, 2),
           fe.HsiehCloughTocher(tri, 3)]
    bt = BatchedTabulator(zoo, order=0)

    # a degree-6 quadrature rule; integrand f = x^2 y
    Q = create_quadrature(tri, 8)
    pts = jnp.asarray(Q.get_points())
    wts = jnp.asarray(Q.get_weights())
    f = pts[:, 0] ** 2 * pts[:, 1]

    M = mo.zoo_moments(bt, pts, wts, f)
    per = mo.unpack_moments(bt, M)
    for el, m in zip(zoo, per):
        print(f"{type(el).__name__:22s} moment vector shape {m.shape}, "
              f"|M|_inf = {np.abs(m).max():.3e}")

    # interpolation transpose: evaluate a coefficient field at points
    rows = max(hi for _lo, hi, _s in bt.slices)
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.random(rows))
    probe = jnp.asarray(rng.random((500, 2)) * 0.4)
    u = jax.jit(lambda q, cc: mo.interpolate_rows(bt, q, cc))(probe, c)
    print(f"interpolated field at 500 points: "
          f"u[:3] = {np.asarray(u[:3])}")

    # sanity: Lagrange moments of f against the mass matrix reproduce
    # the L2 projection (host check)
    el = zoo[0]
    lo, hi, _ = bt.slices[0]
    phi = np.asarray(el.tabulate(0, np.asarray(pts))[(0, 0)])
    mass = (phi * np.asarray(wts)) @ phi.T
    proj = np.linalg.solve(mass, np.asarray(per[0]).ravel())
    resid = np.abs(phi.T @ proj - np.asarray(f)).max()
    print(f"L2-projection residual of x^2*y onto P3 (should be ~0): "
          f"{resid:.2e}")


if __name__ == "__main__":
    main()
