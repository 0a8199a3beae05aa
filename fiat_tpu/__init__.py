"""fiat_tpu: a JAX finite element tabulation framework.

A ground-up JAX/XLA rebuild of the capabilities of the FIAT/FInAT/gem
stack: reference cells, quadrature, orthogonal expansion bases, polynomial
sets, dual bases, the full finite element zoo, a symbolic (traceable)
element layer, and fused batched device tabulation -- with tabulation
expressed as jit-compiled, member-vectorized, matmul-shaped array programs
instead of per-point numpy loops.

Float64 is enabled at import: element construction (Vandermonde solves,
dual-basis Riesz maps) requires double precision to meet the 1e-10
reproduction tolerance of the reference tables.  Device tabulation can
still run in lower precision by casting inputs.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from fiat_tpu.core import cells  # noqa: E402,F401
from fiat_tpu.core.cells import (  # noqa: E402,F401
    TensorProductCell, UFCHexahedron, UFCQuadrilateral, default_simplex,
    symmetric_simplex, ufc_cell, ufc_simplex)
from fiat_tpu.core.finite_element import (  # noqa: E402,F401
    CiarletElement, FiniteElement, entity_support_dofs)
from fiat_tpu.core.quadrature import make_quadrature  # noqa: E402,F401
from fiat_tpu.core.quadrature_schemes import create_quadrature  # noqa: E402,F401
from fiat_tpu.elements import *  # noqa: E402,F401,F403
from fiat_tpu.elements import extra_elements, supported_elements  # noqa: E402,F401

# subpackages imported lazily by most users but re-exported for
# discoverability: fiat_tpu.symbolic (traceable element layer),
# fiat_tpu.ufl (element descriptions), fiat_tpu.factory (descriptions ->
# symbolic elements)
from fiat_tpu import symbolic  # noqa: E402,F401
from fiat_tpu import ufl  # noqa: E402,F401
from fiat_tpu.factory import (  # noqa: E402,F401
    as_fiat_cell, create_base_element, create_element)

__version__ = "0.3.0"
