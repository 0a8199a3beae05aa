"""Checks that need an NVIDIA GPU.  They skip elsewhere; chip_smoke.py
runs them on the card, in the process that holds it."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run python chip_smoke.py on one")


def _zoo():
    from fiat_tpu import elements as fe
    from fiat_tpu.core import cells as cl
    T = cl.ufc_simplex(2)
    return [fe.Lagrange(T, 8), fe.Nedelec(T, 4), fe.Argyris(T, 5),
            fe.HsiehCloughTocher(T, 3)]


def test_device_tabulator_takes_native_engine(gpu):
    from fiat_tpu.ops import device_tabulator, f64_engine
    assert f64_engine() == "native"
    assert device_tabulator(_zoo(), order=1).matmul == "native"


@pytest.mark.parametrize("f64", [True, False])
def test_tables_match_host_on_card(gpu, f64):
    """f64 tables within the parity budget; f32 tables within the f32
    bound, which a TF32 change of basis would miss."""
    import chip_smoke
    from fiat_tpu.ops import device_tabulator
    zoo = _zoo()
    pts = chip_smoke.triangle_points(3000, seed=5)
    tab = device_tabulator(zoo, order=1, f64=f64)
    per = tab.unpack({a: np.asarray(t) for a, t in tab(pts).items()})
    if f64:
        assert chip_smoke.table_error(per, zoo, pts, 1) < chip_smoke.TAB_ATOL
    else:
        err = chip_smoke.table_error(per, zoo, pts, 1, relative=True)
        assert err < chip_smoke.F32_RTOL


def test_ozaki_matmul_on_card(gpu):
    """The multiword bf16 scheme needs exact f32 accumulation of its
    slice products; the card's dot keeps it."""
    import jax.numpy as jnp
    from fiat_tpu.ops.multiword import MultiwordMatmul
    rng = np.random.default_rng(0)
    A = rng.standard_normal((300, 66))
    B = rng.standard_normal((66, 4000))
    C = np.asarray(MultiwordMatmul(A)(jnp.asarray(B)))
    assert np.abs(C - A @ B).max() / np.abs(A @ B).max() < 1e-12
