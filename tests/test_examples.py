"""The examples must keep working — they are the library's front door."""

import runpy
from pathlib import Path

import numpy as np

from sblas import datasets

_EX = Path(__file__).resolve().parent.parent / "examples"


def test_cg_and_ssor_pcg():
    mod = runpy.run_path(str(_EX / "cg.py"))
    a = datasets.poisson2d(24, dtype=np.float32)
    b = np.random.default_rng(1).standard_normal(a.shape[0]).astype(
        np.float32)
    x, it, res = mod["cg"](a, b, tol=1e-5)
    assert res < 1e-5
    xp, itp, resp = mod["cg"](a, b, tol=1e-5,
                              m_solve=mod["ssor_preconditioner"](a))
    assert resp < 1e-5
    assert itp < it, "SSOR preconditioning must reduce iterations"
    err = np.linalg.norm(a.to_scipy() @ xp - b) / np.linalg.norm(b)
    assert err < 5e-5


def test_pagerank_example():
    mod = runpy.run_path(str(_EX / "pagerank.py"))
    g = datasets.emulate("uk-2002", scale=0.01, dtype=np.float32)
    r, it = mod["pagerank"](g, tol=1e-9)
    assert abs(float(r.sum()) - 1.0) < 1e-3
    assert it < 200
    # the f32 solve on the auto route (degree buckets here) agrees with
    # the same iteration in f64
    r64, _ = mod["pagerank"](g.astype(np.float64), tol=1e-12)
    assert np.abs(r64 - r).max() < 1e-5 * float(r64.max())


def test_convection_ilu_example():
    mod = runpy.run_path(str(_EX / "convection_ilu.py"))
    a, b, (x0, plain), (x1, pre) = mod["solve"](nx=24, eps=0.02)
    assert pre["rel_residual"] < 1e-6
    assert pre["iterations"] < plain["iterations"] / 2
    err = (np.linalg.norm(a.to_scipy() @ np.asarray(x1) - b)
           / np.linalg.norm(b))
    assert err < 1e-4
