"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU. The timings it prints here are CPU numbers and mean nothing;
what is checked is that each phase drives its entry point and compares
with its golden."""

import runpy
from pathlib import Path

import numpy as np
import pytest

from sblas import datasets

_SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    return runpy.run_path(str(_SMOKE))


@pytest.fixture
def lines():
    out = []
    return out


def test_main_refuses_without_gpu(smoke, capsys):
    assert smoke["main"]([]) != 0
    assert smoke["main"](["--four-cards"]) != 0
    out, err = capsys.readouterr()
    assert out == ""                  # no result line
    assert "no GPU" in err


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("matrix,route", [("cant", "ell"),
                                          ("uk-2002", "bucket")])
def test_phase_spmv(smoke, lines, matrix, route, dtype):
    a = datasets.emulate(matrix, scale=0.001 if matrix == "uk-2002" else 0.02,
                         dtype=dtype)
    got = smoke["phase_spmv"](a, matrix, lines.append)
    assert got["route"] == route
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert got["rel_err"] <= tol
    assert f"route={route}" in lines[0] and "rel_err=" in lines[0]


def test_phase_cusparse_reference_line(smoke, lines):
    a = datasets.emulate("cant", scale=0.02, dtype=np.float32)
    got = smoke["phase_cusparse"](a, "cant", lines.append)
    assert got["rel_err"] <= 1e-5
    assert "jax.experimental.sparse" in lines[0]


@pytest.mark.parametrize("k", [8, 32])
def test_phase_spmm(smoke, lines, k):
    a = datasets.emulate("consph", scale=0.01, dtype=np.float32)
    got = smoke["phase_spmm"](a, "consph", k, lines.append)
    assert got["rel_err"] <= 1e-5
    assert f"K={k}" in lines[0]


@pytest.mark.parametrize("kind", ["nd", "band"])
def test_phase_sptrsv(smoke, lines, kind):
    l = (smoke["nd_factor"](16) if kind == "nd" else
         datasets.lower_triangular(800, 12, bandwidth=60, seed=1,
                                   dtype=np.float32))
    got = smoke["phase_sptrsv"](l, kind, lines.append, k=4)
    assert set(got) >= {"lower", "trans", "sptrsm K=4", "tiles"}
    assert "triton" not in got        # the kernel route is the GPU's only
    assert any("route=tiles" in ln and "s/tile=" in ln for ln in lines)


def test_phase_cg(smoke, lines):
    got = smoke["phase_cg"](24, lines.append)
    assert got["residual"] <= smoke["TOL"]["cg_residual"]
    assert "iterations=" in lines[0]


def test_phase_memory(smoke, lines):
    a = datasets.emulate("cant", scale=0.01, dtype=np.float32)
    smoke["phase_memory"](a, lines.append)
    assert "CompiledMemoryStats" in lines[0]
    assert "peak_bytes_in_use" in lines[1]


def test_four_cards_phases(smoke, lines):
    """The distributed phases on 4 of the 8 virtual CPU devices."""
    smoke["four_cards"](lines.append, uk_scale=0.002, nd=16, grid=16)
    text = "\n".join(lines)
    for what in ("nnz_balanced", "nnz_split", "dist_spmm", "dist_sptrsv",
                 "dist_cg"):
        assert what in text


def test_band_factor_shape(smoke):
    l = smoke["band_factor"]()
    assert l.shape == (62451, 62451)


def test_check_raises_past_tolerance(smoke):
    smoke["_check"]("ok", 1e-6, 1e-5)
    with pytest.raises(AssertionError, match="rel_err"):
        smoke["_check"]("bad", 2e-5, 1e-5)
    with pytest.raises(AssertionError):
        smoke["_check"]("nan", float("nan"), 1e-5)
