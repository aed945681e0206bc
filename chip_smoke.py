"""Smoke run of sblas on an NVIDIA GPU through its public entry points.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the distributed phases

One card, at published SuiteSparse widths (matrices generated from a seed
by ``sblas.datasets``):

1. card     — ``nvidia-smi`` name and power limit, JAX's device kind;
2. spmv     — cant (62,451 rows, 4.0M nnz) in f32 and f64, uk-2002 at
              scale 0.05 (926K rows, 14.4M nnz), and one reference line
              for ``jax.experimental.sparse``'s CSR matvec on cant;
3. spmm     — consph (83,334 rows, 6.0M nnz) at K = 8 and K = 32;
4. sptrsv   — the nested-dissection Cholesky factor of a 120x120 grid
              and a 541-level band factor, ``lower`` and ``trans``, and
              SpTRSM at K = 8; every SpTRSV route timed on one schedule;
5. solver   — CG with an IC(0) preconditioner on a 256x256 Poisson grid;
6. memory   — ``memory_analysis()`` of one jitted step, peak device bytes;
7. tests    — the test suite's ``gpu``-marked tests, in this process.

Every phase compares with the scipy golden and raises past its tolerance
(``TOL``). Each line before the last names the card; the last line is one
JSON object. The script exits non-zero, printing no result, when JAX finds
no GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances on rel_err (max-norm, against the float64 scipy golden):
TOL = {
    # reduction order differs from scipy's, and the bucket route's
    # scatter-add uses atomics whose order changes from run to run
    "spmv_f32": 1e-5,
    "spmm_f32": 1e-5,
    "f64": 1e-12,
    # forward substitution carries each level's rounding into the next
    "sptrsv_f32": 1e-4,
    # CG stops on its recurrence residual (CG_TOL); the true residual of
    # the f32 iterate drifts from it by rounding in every update (about
    # iterations x eps32 x cond; 2.2e-5 on poisson2d(256) on an H100)
    "cg_residual": 1e-4,
}
CG_TOL = 1e-6
REPS = 10


def nvidia_smi() -> str:
    """The card's name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def seconds_per_call(fn, *args, reps: int = REPS) -> float:
    """Median host-clock seconds of ``fn(*args)`` through
    ``block_until_ready``, after one warm-up call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _check(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{what}: rel_err {err:.3e} > tol {tol:.0e}")


def phase_spmv(a, name: str, log) -> dict:
    """Auto-routed ``sblas.spmv`` against the float64 golden."""
    import jax.numpy as jnp

    import sblas
    from sblas.golden import rel_err, spmv_golden
    from sblas.ops.spmv import _get_plan

    plan = _get_plan(a, "auto")
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(a.dtype)
    xd = jnp.asarray(x)
    err = rel_err(sblas.spmv(a, xd), spmv_golden(a, x.astype(np.float64)))
    tol = TOL["f64"] if a.dtype == np.float64 else TOL["spmv_f32"]
    secs = seconds_per_call(sblas.spmv, a, xd)
    log(f"spmv {name} {np.dtype(a.dtype).name} route={plan.method} "
        f"s/call={secs:.6e} GB/s={plan.bytes_per_iter / secs / 1e9:.1f} "
        f"rel_err={err:.3e} tol={tol:.0e}")
    _check(f"spmv {name}", err, tol)
    return {"route": plan.method, "seconds": secs, "rel_err": err}


def phase_cusparse(a, name: str, log) -> dict:
    """Reference line: ``jax.experimental.sparse`` CSR matvec, which
    lowers to cuSPARSE on a GPU. Not a route of this library."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from sblas.golden import rel_err, spmv_golden

    m = jsparse.CSR((jnp.asarray(a.data), jnp.asarray(a.indices),
                     jnp.asarray(a.indptr)), shape=a.shape)
    x = np.random.default_rng(1).standard_normal(a.shape[1]).astype(a.dtype)
    f = jax.jit(lambda m, x: m @ x)
    xd = jnp.asarray(x)
    err = rel_err(f(m, xd), spmv_golden(a, x.astype(np.float64)))
    secs = seconds_per_call(f, m, xd)
    log(f"spmv {name} {np.dtype(a.dtype).name} reference=jax.experimental."
        f"sparse.CSR s/call={secs:.6e} rel_err={err:.3e}")
    _check(f"cusparse {name}", err, TOL["spmv_f32"])
    return {"seconds": secs, "rel_err": err}


def phase_spmm(a, name: str, k: int, log) -> dict:
    """Auto-routed ``sblas.spmm`` at K columns against the golden."""
    import jax.numpy as jnp

    import sblas
    from sblas.golden import rel_err, spmm_golden
    from sblas.ops.spmm import SpmmPlan
    from sblas.ops.spmv import _PLAN_CACHE

    x = np.random.default_rng(2).standard_normal(
        (a.shape[1], k)).astype(a.dtype)
    xd = jnp.asarray(x)
    err = rel_err(sblas.spmm(a, xd), spmm_golden(a, x.astype(np.float64)))
    plan = next(p for key, p in _PLAN_CACHE[a].items()
                if key[:2] == ("spmm", "auto"))
    assert isinstance(plan, SpmmPlan)
    tol = TOL["f64"] if a.dtype == np.float64 else TOL["spmm_f32"]
    secs = seconds_per_call(sblas.spmm, a, xd)
    nbytes = plan.bytes_per_iter_nx + (a.shape[0] + a.shape[1]) * k * (
        a.data.itemsize)
    log(f"spmm {name} K={k} {np.dtype(a.dtype).name} route={plan.method} "
        f"s/call={secs:.6e} GB/s={nbytes / secs / 1e9:.1f} "
        f"rel_err={err:.3e} tol={tol:.0e}")
    _check(f"spmm {name} K={k}", err, tol)
    return {"route": plan.method, "seconds": secs, "rel_err": err}


def phase_sptrsv(l, name: str, log, k: int = 8) -> dict:
    """``sblas.sptrsv`` (lower and trans) and ``sblas.sptrsm`` at K
    columns against the golden, then every SpTRSV route of this platform
    timed on the same schedule, in turns."""
    import jax.numpy as jnp

    import sblas
    from sblas.formats import csr_transpose
    from sblas.golden import rel_err, sptrsm_golden, sptrsv_golden
    from sblas.ops.sptrsv import SptrsvPlan
    from sblas.utils.backend import platform

    tol = TOL["f64"] if l.dtype == np.float64 else TOL["sptrsv_f32"]
    rng = np.random.default_rng(3)
    b = rng.standard_normal(l.shape[0]).astype(l.dtype)
    bk = rng.standard_normal((l.shape[0], k)).astype(l.dtype)
    bd, bkd = jnp.asarray(b), jnp.asarray(bk)
    lt = csr_transpose(l)
    out = {}
    for what, got, ref in (
            ("lower", lambda: sblas.sptrsv(l, bd),
             lambda: sptrsv_golden(l, b.astype(np.float64))),
            ("trans", lambda: sblas.sptrsv(l, bd, trans=True),
             lambda: sptrsv_golden(lt, b.astype(np.float64), lower=False)),
            (f"sptrsm K={k}", lambda: sblas.sptrsm(l, bkd),
             lambda: sptrsm_golden(l, bk.astype(np.float64)))):
        err = rel_err(got(), ref())
        log(f"sptrsv {name} {what} rel_err={err:.3e} tol={tol:.0e}")
        _check(f"sptrsv {name} {what}", err, tol)
        out[what] = err

    methods = ("tiles", "triton") if platform() == "gpu" else ("tiles",)
    plans = {m: SptrsvPlan(l, method=m) for m in methods}
    for m, p in plans.items():
        err = rel_err(p(bd), sptrsv_golden(l, b.astype(np.float64)))
        _check(f"sptrsv {name} route={m}", err, tol)
    times = {m: [] for m in methods}
    order = list(methods) + list(reversed(methods))
    for m in order:
        times[m].append(seconds_per_call(plans[m], bd))
    p0 = plans["tiles"]
    for m in methods:
        secs = float(np.min(times[m]))
        log(f"sptrsv {name} route={m} levels={p0.nlevels} "
            f"tiles={p0.num_tiles} tile_rows={p0.tile_rows} "
            f"s/call={secs:.6e} s/tile={secs / p0.num_tiles:.3e}")
        out[m] = secs
    return out


def phase_cg(n: int, log) -> dict:
    """``sblas.solvers.cg`` with IC(0) on an n x n Poisson grid, f32."""
    import sblas
    from sblas import datasets

    a = datasets.poisson2d(n, dtype=np.float32)
    b = np.random.default_rng(4).standard_normal(a.shape[0]).astype(
        np.float32)
    t0 = time.perf_counter()
    x, info = sblas.solvers.cg(a, b, tol=CG_TOL, maxiter=5000,
                               M=sblas.solvers.ichol(a))
    x = np.asarray(x)
    secs = time.perf_counter() - t0
    res = float(np.linalg.norm(b - a.to_scipy() @ x.astype(np.float64))
                / np.linalg.norm(b))
    log(f"cg+ichol poisson2d({n}) n={a.shape[0]} "
        f"iterations={info['iterations']} "
        f"rel_residual={info['rel_residual']:.3e} host_residual={res:.3e} "
        f"tol={TOL['cg_residual']:.0e} seconds(incl. build+compile)="
        f"{secs:.3f}")
    if not (info["rel_residual"] <= CG_TOL and res <= TOL["cg_residual"]):
        raise AssertionError(f"cg did not converge: {info}, host {res:.3e}")
    return {"iterations": info["iterations"], "residual": res}


def phase_memory(a, log) -> dict:
    """``memory_analysis()`` of one jitted SpMV step, and the device's
    peak bytes in use so far."""
    import jax
    import jax.numpy as jnp

    from sblas.ops.spmv import _get_plan

    plan = _get_plan(a, "auto")
    x = jnp.zeros(a.shape[1], a.dtype)
    compiled = jax.jit(plan.apply_pure).lower(
        plan.device_arrays(), x).compile()
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    log(f"memory spmv step: {mem}")
    log(f"memory peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return {"peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def phase_gpu_tests(log) -> None:
    """The test suite's ``gpu``-marked tests, run in this process (a second
    JAX process could not get the card's memory)."""
    import contextlib
    import io
    import os
    from pathlib import Path

    import pytest

    class Outcomes:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            self.passed += report.when == "call" and report.passed
            self.skipped += bool(report.skipped)

    # the tests' conftest keeps the platform JAX_PLATFORMS names
    os.environ["JAX_PLATFORMS"] = "cuda"
    seen = Outcomes()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          str(Path(__file__).resolve().parent / "tests")],
                         plugins=[seen])
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"pytest -m gpu: {line}")
    if rc != 0 or seen.passed == 0 or seen.skipped:
        raise AssertionError(
            f"gpu-marked tests: exit {rc}, {seen.passed} passed, "
            f"{seen.skipped} skipped")


def one_card(log) -> None:
    from sblas import datasets

    cant = datasets.emulate("cant", dtype=np.float32)
    phase_spmv(cant, "cant", log)
    phase_spmv(cant.astype(np.float64), "cant", log)
    phase_spmv(datasets.emulate("uk-2002", scale=0.05, dtype=np.float32),
               "uk-2002@0.05", log)
    phase_cusparse(cant, "cant", log)
    consph = datasets.emulate("consph", dtype=np.float32)
    for k in (8, 32):
        phase_spmm(consph, "consph", k, log)
    phase_sptrsv(nd_factor(120), "chol-nd-120", log)
    phase_sptrsv(band_factor(), "band-62451", log)
    phase_cg(256, log)
    phase_memory(cant, log)
    phase_gpu_tests(log)


def nd_factor(n: int):
    """Cholesky factor of the nested-dissection-ordered n x n Poisson grid."""
    from sblas import datasets

    return datasets.cholesky_factor(datasets.poisson2d_nd(n, dtype=np.float64),
                                    dtype=np.float32)


def band_factor():
    """The 62,451-row band factor with 541 levels."""
    from sblas import datasets

    return datasets.lower_triangular(62451, 30, bandwidth=4000, seed=1,
                                     dtype=np.float32)


# uk-2002 scale for the four-card phases: 9.3M rows, 136M nnz. The plan
# itself builds in seconds at full scale; the single-threaded generator
# (minutes at full scale) is what sets the cut.
UK_SCALE_4 = 0.5


def four_cards(log, uk_scale: float = UK_SCALE_4, nd: int = 120,
               grid: int = 256) -> None:
    """Distributed phases on a 4-device mesh, each against its golden:
    DistSpmvPlan (nnz_balanced, nnz_split) and DistSpmmPlan (K=8) on
    uk-2002 at ``uk_scale``, DistSptrsvPlan on the chol-nd factor of an
    ``nd`` x ``nd`` grid, and dist_cg on a ``grid`` x ``grid`` Poisson
    matrix."""
    import jax

    from sblas import datasets
    from sblas.golden import rel_err, spmm_golden, spmv_golden, sptrsv_golden
    from sblas.parallel import (DistSpmmPlan, DistSpmvPlan, DistSptrsvPlan,
                                dist_cg, make_mesh)

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, "
                           f"have {len(jax.devices())}")
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    g = datasets.emulate("uk-2002", scale=uk_scale, dtype=np.float32)
    log(f"uk-2002@{uk_scale}: {g.shape[0]} rows, {g.nnz} nnz "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    x = np.random.default_rng(1).standard_normal(g.shape[1]).astype(
        np.float32)
    ref = spmv_golden(g, x.astype(np.float64))
    for strategy in ("nnz_balanced", "nnz_split"):
        t0 = time.perf_counter()
        plan = DistSpmvPlan(g, mesh, strategy=strategy)
        build = time.perf_counter() - t0
        err = rel_err(plan(x), ref)
        secs = seconds_per_call(plan, x)
        log(f"dist_spmv uk-2002@{uk_scale} {strategy} "
            f"local={plan.local_method} build_s={build:.1f} "
            f"s/call={secs:.6e} rel_err={err:.3e}")
        _check(f"dist_spmv {strategy}", err, TOL["spmv_f32"])
        del plan
    xk = np.random.default_rng(2).standard_normal(
        (g.shape[1], 8)).astype(np.float32)
    plan = DistSpmmPlan(g, mesh)
    err = rel_err(plan(xk), spmm_golden(g, xk.astype(np.float64)))
    secs = seconds_per_call(plan, xk)
    log(f"dist_spmm uk-2002@{uk_scale} K=8 local={plan.local_method} "
        f"s/call={secs:.6e} rel_err={err:.3e}")
    _check("dist_spmm", err, TOL["spmm_f32"])
    del plan

    l = nd_factor(nd)
    b = np.random.default_rng(3).standard_normal(l.shape[0]).astype(
        np.float32)
    plan = DistSptrsvPlan(l, mesh)
    err = rel_err(plan(b), sptrsv_golden(l, b.astype(np.float64)))
    secs = seconds_per_call(plan, b)
    log(f"dist_sptrsv chol-nd-{nd} s/call={secs:.6e} rel_err={err:.3e}")
    _check("dist_sptrsv", err, TOL["sptrsv_f32"])

    a = datasets.poisson2d(grid, dtype=np.float32)
    b = np.random.default_rng(4).standard_normal(a.shape[0]).astype(
        np.float32)
    xc, info = dist_cg(a, b, mesh=mesh, tol=CG_TOL, maxiter=5000)
    res = float(np.linalg.norm(b - a.to_scipy() @ np.asarray(
        xc, dtype=np.float64)) / np.linalg.norm(b))
    log(f"dist_cg poisson2d({grid}) iterations={info['iterations']} "
        f"rel_residual={info['rel_residual']:.3e} host_residual={res:.3e}")
    if not (info["rel_residual"] <= CG_TOL and res <= TOL["cg_residual"]):
        raise AssertionError(f"dist_cg did not converge: {info}, "
                             f"host {res:.3e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the distributed phases, on 4 cards")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform!r})",
              file=sys.stderr)
        return 1
    import sblas  # noqa: F401  (fails here when run outside the repo)
    from sblas.utils.backend import use_compile_cache

    use_compile_cache()
    kind = jax.devices()[0].device_kind

    def log(msg: str) -> None:
        print(f"[{kind}] {msg}", flush=True)

    log(f"nvidia-smi: {nvidia_smi()}")
    log(f"jax {jax.__version__} devices={len(jax.devices())}")
    if args.four_cards:
        four_cards(log)
    else:
        one_card(log)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
