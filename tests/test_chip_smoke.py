"""The chip smoke test's helpers on tiny CPU shapes: its phases, its
oracle comparisons and its exit codes.  The phases at full size run on
the card (python chip_smoke.py)."""

import json

import numpy as np
import pytest

import chip_smoke
from bench import device_peaks
from fiat_tpu import elements as fe
from fiat_tpu.core import cells as cl

T = cl.ufc_simplex(2)


def _smoke():
    zoo = [fe.Lagrange(T, 3), fe.RaviartThomas(T, 2), fe.CubicHermite(T),
           fe.HsiehCloughTocher(T, 3)]
    return chip_smoke.Smoke(zoo, npts_tab=600, npts_mom=1200,
                            ncheck_tab=100, ncheck_mom=400, reps=1)


def test_main_without_gpu_exits_nonzero(capsys):
    """On the CPU JAX finds no GPU: exit code 2 and no result line."""
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "no GPU" in err


def test_failed_phase_prints_no_ok_line(capsys):
    ran = []

    def fail():
        raise chip_smoke.PhaseFailed("tables differ")
    phases = [("a", lambda: ran.append("a")), ("b", fail),
              ("c", lambda: ran.append("c"))]
    assert chip_smoke.run_phases(phases, {"platform": "gpu"}) == 1
    assert ran == ["a"]
    out = capsys.readouterr().out
    assert "phase b FAILED" in out and '"ok"' not in out


def test_passed_phases_end_with_ok_line(capsys):
    device = {"platform": "gpu", "kind": "card", "count": 1}
    assert chip_smoke.run_phases([("a", lambda: None)], device) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": device}


@pytest.mark.parametrize("err", [2e-10, float("nan")])
def test_check_rejects_excess_and_nan(err):
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.check("tables", err, 1e-10)


def test_table_error_sees_one_wrong_entry():
    """The oracle comparison finds a perturbation of a single entry of
    one derivative table of one element."""
    smoke = _smoke()
    tab = smoke.tabulator(1, "native")
    pts = smoke.pts_tab[:50]
    tables = {a: np.array(t) for a, t in tab(pts).items()}
    assert chip_smoke.table_error(tab.unpack(tables), smoke.zoo, pts,
                                  1) < 1e-10
    tables[(0, 1)][-1, 7] += 1e-8
    err = chip_smoke.table_error(tab.unpack(tables), smoke.zoo, pts, 1)
    assert 0.9e-8 < err < 1.1e-8


@pytest.mark.parametrize("phase", ["tabulation", "moments"])
def test_phase_passes_on_tiny_shapes(phase):
    smoke = _smoke()
    getattr(smoke, phase)()
    assert phase in smoke.results


def test_engines_phase_on_tiny_shapes():
    smoke = _smoke()
    smoke.engines({"hbm_bytes_s": 1e12}, "card, 1 W")
    out = smoke.results["engines"]
    for engine in ("native", "ozaki"):
        assert out[engine]["tabulate_max_abs_err"] < chip_smoke.TAB_ATOL
        assert out[engine]["moments_max_rel_err"] < chip_smoke.MOM_RTOL
    assert out["floors_s"]["tabulate"] == pytest.approx(
        smoke.rows * 3 * 600 * 8 / 1e12)


def test_sharded_phase_on_four_virtual_devices():
    smoke = _smoke()
    smoke.sharded(4)
    assert smoke.results["sharded"]["moments_2d_rel_err"] \
        <= chip_smoke.SHARD_RTOL


def test_peaks_table_rejects_unknown_device():
    assert device_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_s"] == 3.35e12
    with pytest.raises(KeyError, match="cpu"):
        device_peaks("cpu")
