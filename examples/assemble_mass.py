"""End-to-end example: reference mass and stiffness matrices on device.

Demonstrates the whole stack the way a Firedrake-style consumer would
use it:

1. describe the element (fiat_tpu.ufl) and convert it (factory);
2. build a quadrature rule;
3. tabulate basis values/gradients at the quadrature points on the
   device (one jitted program via BatchedTabulator);
4. contract to the reference-cell mass matrix  M_ij = sum_q w_q phi_i
   phi_j  and stiffness matrix  K_ij = sum_q w_q grad phi_i . grad
   phi_j  as device GEMMs;
5. optionally shard the quadrature batch over a device mesh
   (fiat_tpu.parallel) -- the contraction's point reduction becomes a
   psum across the devices.

Run: python examples/assemble_mass.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import fiat_tpu
from fiat_tpu.core.quadrature_schemes import create_quadrature
from fiat_tpu.ops.tabulate import BatchedTabulator


def main():
    # 1. describe + convert
    desc = fiat_tpu.ufl.FiniteElement("Lagrange", "triangle", 4,
                                      variant="equispaced")
    element = fiat_tpu.create_element(desc)
    fiat_element = element.fiat_equivalent
    cell = fiat_element.get_reference_element()
    n = element.space_dimension()

    # 2. quadrature exact for products of gradients
    Q = create_quadrature(cell, 2 * desc.degree())
    pts = jnp.asarray(Q.get_points())
    wts = jnp.asarray(Q.get_weights())

    # 3 + 4. one jitted program: tabulate + contract
    tab = BatchedTabulator([fiat_element], order=1)

    @jax.jit
    def assemble(points, weights):
        tables = tab._tabulate(points)
        phi = tables[(0, 0)]                       # (n, nq)
        grads = jnp.stack([tables[(1, 0)], tables[(0, 1)]])  # (2, n, nq)
        M = (phi * weights) @ phi.T
        K = jnp.einsum("kiq,q,kjq->ij", grads, weights, grads)
        return M, K

    M, K = assemble(pts, wts)
    M, K = np.asarray(M), np.asarray(K)

    # sanity: sum of all mass entries = cell volume; K annihilates
    # constants
    print(f"element: {desc}  ({n} dofs)")
    print(f"quadrature points: {len(np.asarray(pts))}")
    print(f"sum(M) = {M.sum():.15f}  (cell volume = {cell.volume():.15f})")
    print(f"|K @ 1| = {np.abs(K @ np.ones(n)).max():.2e} (should be ~0)")
    print(f"cond(M) = {np.linalg.cond(M):.2e}")


if __name__ == "__main__":
    main()
