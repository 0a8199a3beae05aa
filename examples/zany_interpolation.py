"""End-to-end example: physically mapped (zany) elements + dual
evaluation, the way a form compiler consumes the symbolic layer.

1. build a Hsieh-Clough-Tocher element through the UFL description +
   factory (the finat-equivalent path);
2. supply the PhysicalGeometry of a distorted cell (the TSFC role);
3. basis_evaluation(..., coordinate_mapping=...) returns PHYSICAL basis
   tables: the C1 basis transformation (Jacobians, physical normals,
   edge lengths) is a dense matrix folded into the tabulation as one
   matmul;
4. verify by reproducing a physical-frame polynomial from its physical
   derivative DoFs;
5. dual_evaluation interpolates a function into a Lagrange space and
   point_evaluation checks the result -- the reference's
   interpolation-operator workflow (finat/finiteelementbase.py:245).

Run: python examples/zany_interpolation.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import fiat_tpu  # noqa: E402
from fiat_tpu import ufl as fufl  # noqa: E402
from fiat_tpu.core import cells as cl  # noqa: E402
from fiat_tpu.factory import create_element  # noqa: E402
from fiat_tpu.symbolic.point_set import PointSet  # noqa: E402


class AffineGeometry:
    """PhysicalGeometry callbacks for an affinely-mapped cell (the role
    the form compiler plays when it hands Jacobians to the element)."""

    def __init__(self, ref_cell, phys_cell):
        from fiat_tpu.core.cells import make_affine_mapping
        self.ref_cell, self.phys_cell = ref_cell, phys_cell
        self.A, self.b = make_affine_mapping(ref_cell.vertices,
                                             phys_cell.vertices)

    def cell_size(self):
        return np.ones((len(self.ref_cell.vertices),))

    def detJ_at(self, point):
        return np.linalg.det(self.A)

    def jacobian_at(self, point):
        return self.A

    def reference_normals(self):
        top = self.ref_cell.get_topology()
        return np.asarray([self.ref_cell.compute_normal(i)
                           for i in sorted(top[1])])

    def physical_normals(self):
        top = self.phys_cell.get_topology()
        return np.asarray([self.phys_cell.compute_normal(i)
                           for i in sorted(top[1])])

    def physical_tangents(self):
        top = self.phys_cell.get_topology()
        return np.asarray([
            self.phys_cell.compute_normalized_edge_tangent(i)
            for i in sorted(top[1])])

    def physical_edge_lengths(self):
        top = self.phys_cell.get_topology()
        return np.asarray([self.phys_cell.volume_of_subcomplex(1, i)
                           for i in sorted(top[1])])

    def physical_points(self, ps, entity=None):
        return np.asarray([self.A @ x + self.b for x in ps.points])

    def physical_vertices(self):
        return np.asarray(self.phys_cell.vertices)

    def normalized_reference_edge_tangents(self):
        top = self.ref_cell.get_topology()
        return np.asarray([
            self.ref_cell.compute_normalized_edge_tangent(i)
            for i in sorted(top[1])])


def distorted_geometry():
    ref_cell = cl.ufc_simplex(2)
    phys_cell = cl.ufc_simplex(2)
    phys_cell.vertices = ((0.0, 0.1), (1.17, -0.09), (0.15, 1.84))
    return ref_cell, phys_cell, AffineGeometry(ref_cell, phys_cell)


def main():
    ref_cell, phys_cell, geometry = distorted_geometry()

    # -- zany tabulation ---------------------------------------------------
    from fiat_tpu import symbolic
    hct = symbolic.HsiehCloughTocher(ref_cell, 3, avg=True)
    # points on every SUBCELL of the macro complex: parent-cell lattice
    # points alone do not pin a piecewise-cubic C1 space
    ref_complex = hct._element.get_reference_complex()
    top = ref_complex.get_topology()
    pts = np.asarray([p for c in sorted(top[2])
                      for p in ref_complex.make_points(2, c, 6)])
    ps = PointSet(pts)
    phys_tables = hct.basis_evaluation(1, ps, coordinate_mapping=geometry)

    # a cubic in the PHYSICAL frame; its DoF vector in the PHYSICAL
    # element's own nodal basis comes from a least-squares fit against
    # the physical-cell tabulation (the numeric zoo on the distorted
    # cell is the ground truth the zany transformation must reproduce)
    A, b = geometry.A, geometry.b
    f = lambda X: X[..., 0] ** 3 - 2.0 * X[..., 0] * X[..., 1] ** 2  # noqa: E731
    df = lambda X: np.stack([3 * X[..., 0] ** 2 - 2 * X[..., 1] ** 2,  # noqa: E731
                             -4.0 * X[..., 0] * X[..., 1]], axis=-1)
    phys_hct = symbolic.HsiehCloughTocher(phys_cell, 3,
                                          avg=True).fiat_equivalent
    phys_pts = pts @ A.T + b
    tab_phys = np.asarray(phys_hct.tabulate(0, phys_pts)[(0, 0)])
    dofs, *_ = np.linalg.lstsq(tab_phys.T, f(phys_pts), rcond=None)

    recon = dofs @ np.asarray(phys_tables[(0, 0)])
    err = np.abs(recon - f(phys_pts)).max()
    print(f"HCT physical-frame cubic reproduction: max err {err:.2e}")
    assert err < 1e-10

    # gradients transform too: d/dx via the (0,1)/(1,0) tables and J^-T
    grad_ref = np.stack([dofs @ np.asarray(phys_tables[(1, 0)]),
                         dofs @ np.asarray(phys_tables[(0, 1)])])
    grad_phys = np.linalg.inv(A).T @ grad_ref
    err_g = np.abs(grad_phys.T - df(phys_pts)).max()
    print(f"HCT physical gradient reproduction:    max err {err_g:.2e}")
    assert err_g < 1e-9

    # -- dual evaluation (interpolation) -----------------------------------
    p4 = create_element(fufl.FiniteElement("Lagrange", fufl.triangle, 4))
    target = lambda X: X[..., 0] ** 4 - X[..., 0] * X[..., 1] ** 3 + 0.5  # noqa: E731
    coeffs = p4.dual_evaluation(lambda ps_: target(np.asarray(ps_.points)))
    check = np.asarray(ref_cell.make_points(2, 0, 7))
    vals = np.asarray(coeffs) @ np.asarray(
        p4.basis_evaluation(0, PointSet(check))[(0, 0)])
    err_i = np.abs(vals - target(check)).max()
    print(f"P4 dual-evaluation interpolation:      max err {err_i:.2e}")
    assert err_i < 1e-11
    print("ok")


if __name__ == "__main__":
    main()
