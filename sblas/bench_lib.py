"""Benchmark drivers shared by the CLI and the top-level bench.py
(layer L5, SURVEY.md C14).

Each bench builds a plan, wraps it in a carry-dependent step (so the timing
harness's fori_loop cannot elide or reorder iterations), measures marginal
seconds/iteration, and reports GFLOP/s and GB/s (from the plan's explicit
bytes model). Device arrays flow through explicit jit arguments
(``plan.device_arrays()`` + ``plan.apply_pure``): closure capture would
embed them in the compiled program as constants. Every record names the
device it ran on (:func:`sblas.utils.timing.device_info`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .formats import CSR
from .golden import (spmv_golden, spmm_golden, sptrsv_golden, sptrsm_golden,
                     rel_err, default_tol)
from .ops.spmv import SpmvPlan
from .ops.spmm import SpmmPlan
from .ops.sptrsv import SptrsvPlan
from .ops.sptrsm import SptrsmPlan
from .utils.timing import BenchRecord, measure_seconds_per_iter, stream_bandwidth

# Keeps the carry numerically equal to x0 while forcing a data dependency on
# the previous iteration's output (tiny*y underflows against x0).
_EPS = 1e-30


def _attach_stream(rec: BenchRecord) -> None:
    if "pct_stream" not in rec.extra:
        sbw = stream_bandwidth()
        rec.extra["stream_gbps"] = sbw
        rec.extra["pct_stream"] = 100.0 * rec.gbps / sbw


def _measure(step, x0, arrs, iters, ratio_pairs, nbytes, extra):
    """Marginal seconds/iteration of ``step``; with ``ratio_pairs=N`` (N>1)
    also N back-to-back (kernel, fresh STREAM) sample pairs, keeping the
    pair with the median bytes ratio so slow device drift cancels."""
    def one():
        with jax.profiler.TraceAnnotation("kernel"):
            return measure_seconds_per_iter(step, x0, arrs, x0,
                                            iters_lo=max(iters // 5, 2),
                                            iters_hi=iters)

    if ratio_pairs <= 1:
        return one()
    pairs = []
    for _ in range(ratio_pairs):
        per = one()
        sbw = stream_bandwidth(fresh=True)
        pairs.append((nbytes / per / 1e9 / sbw, per, sbw))
    pairs.sort()
    ratio, per, sbw = pairs[len(pairs) // 2]
    extra["protocol"] = f"ratio-median-of-{ratio_pairs}"
    extra["ratio_pairs"] = [{"pct": 100 * r, "us": p * 1e6, "stream_gbps": s}
                            for r, p, s in pairs]
    extra["stream_gbps"] = sbw
    extra["pct_stream"] = 100.0 * ratio
    return per


def bench_spmv(a: CSR, *, method: str = "auto", validate: bool = True,
               iters: int = 25, with_stream_pct: bool = True,
               ratio_pairs: int = 0) -> BenchRecord:
    """One SpMV benchmark record (square ``a``: the output feeds back)."""
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    with jax.profiler.TraceAnnotation("retile"):
        plan = SpmvPlan(a, method)
    rng = np.random.default_rng(0)
    with jax.profiler.TraceAnnotation("H2D"):
        x0 = jnp.asarray(rng.standard_normal(n).astype(a.dtype))

    extra = {"method": plan.method, "nnz": a.nnz, "m": m,
             "dtype": str(np.dtype(a.dtype)),
             "fill": getattr(plan, "fill", 1.0)}
    if validate:
        err = rel_err(np.asarray(plan(x0)),
                      spmv_golden(a, np.asarray(x0, dtype=a.dtype)))
        extra["rel_err"] = err
        assert err < default_tol(a.dtype), f"validation failed: {err}"

    def step(x, arrs, x0):
        return x0 + _EPS * plan.apply_pure(arrs, x)

    nbytes = plan.bytes_per_iter + 2 * n * a.data.itemsize
    per = _measure(step, x0, plan.device_arrays(), iters, ratio_pairs,
                   nbytes, extra)
    rec = BenchRecord(name="spmv", seconds_per_iter=per, flops=2.0 * a.nnz,
                      bytes=nbytes, extra=extra)
    if with_stream_pct:
        _attach_stream(rec)
    return rec


def bench_spmm(a: CSR, k: int = 8, *, method: str = "auto",
               validate: bool = True, iters: int = 25,
               with_stream_pct: bool = True,
               ratio_pairs: int = 0) -> BenchRecord:
    """One SpMM benchmark record at K right-hand sides."""
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices")
    with jax.profiler.TraceAnnotation("retile"):
        plan = SpmmPlan(a, method, k_hint=k)
    rng = np.random.default_rng(0)
    with jax.profiler.TraceAnnotation("H2D"):
        x0 = jnp.asarray(rng.standard_normal((n, k)).astype(a.dtype))

    extra = {"method": plan.method, "nnz": a.nnz, "m": m, "k": k,
             "dtype": str(np.dtype(a.dtype))}
    if validate:
        err = rel_err(np.asarray(plan(x0)), spmm_golden(a, np.asarray(x0)))
        extra["rel_err"] = err
        assert err < default_tol(a.dtype), f"validation failed: {err}"

    def step(x, arrs, x0):
        return x0 + _EPS * plan.apply_pure(arrs, x)

    nbytes = plan.bytes_per_iter_nx + (m + 3 * n) * k * a.data.itemsize
    per = _measure(step, x0, plan.device_arrays(), iters, ratio_pairs,
                   nbytes, extra)
    rec = BenchRecord(name=f"spmm_k{k}", seconds_per_iter=per,
                      flops=2.0 * a.nnz * k, bytes=nbytes, extra=extra)
    if with_stream_pct:
        _attach_stream(rec)
    return rec


def sptrsv_reference_pure(l: CSR):
    """The naive jnp masked-wavefront solver (BASELINE config #3's '>=10x
    over pure-jnp loop' baseline): per level, recompute the full residual and
    update only that level's rows — O(nlevels * nnz) work, no schedule.

    Returns (solve(arrs, b), arrs, nlevels)."""
    from .sptrsv_schedule import build_level_schedule
    from .retile import to_ell

    n = l.shape[0]
    sched = build_level_schedule(l)
    ell = to_ell(l)
    is_diag = ell.col == np.arange(ell.col.shape[0])[:, None]
    diag = np.ones(n, dtype=l.data.dtype)
    coo = l.tocoo()
    dm = coo.row == coo.col
    diag[coo.row[dm]] = coo.data[dm]
    nlevels = sched.nlevels
    mp = ell.col.shape[0]

    arrs = {
        "col": jnp.asarray(ell.col),
        "val_off": jnp.asarray(np.where(is_diag, 0.0, ell.val).astype(l.data.dtype)),
        "inv_diag": jnp.asarray((1.0 / diag).astype(l.data.dtype)),
        "levels": jnp.asarray(sched.levels),
    }

    def solve(arrs, b):
        def body(lv, x):
            acc = jnp.sum(arrs["val_off"] * x[arrs["col"]], axis=1)[:n]
            xb = (b - acc) * arrs["inv_diag"]
            xn = jnp.where(arrs["levels"] == lv, xb, x[:n])
            return jnp.concatenate([xn, jnp.zeros(mp - n + 1, xn.dtype)]) \
                if mp + 1 > n else xn

        xp = jnp.zeros(max(mp, n) + 1, dtype=b.dtype)
        xp = lax.fori_loop(0, nlevels, body, xp)
        return xp[:n]

    return solve, arrs, nlevels


def bench_sptrsv(l: CSR, *, validate: bool = True, iters: int = 20,
                 compare_reference: bool = False,
                 tile_rows: int = 0, method: str = "auto",
                 sweeps: int | None = None) -> BenchRecord:
    n = l.shape[0]
    if method == "jacobi":
        from .ops.sptrsv_iter import SptrsvJacobiPlan

        plan = SptrsvJacobiPlan(l, sweeps=sweeps)
    else:
        plan = SptrsvPlan(l, tile_rows=tile_rows, method=method)
    rng = np.random.default_rng(0)
    b0 = jnp.asarray(rng.standard_normal(n).astype(l.dtype))

    extra = {"nnz": l.nnz, "n": n, "nlevels": plan.nlevels,
             "method": plan.method,
             "dtype": str(np.dtype(l.dtype))}
    if method == "jacobi":
        extra["sweeps"] = plan.sweeps
    else:
        extra["tile_rows"] = plan.tile_rows
        extra["padding_ratio"] = plan.padding_ratio
    if validate:
        x = np.asarray(plan(b0))
        # upcast b to the matrix dtype for the golden (exact for f32->f64):
        # sptrsv_golden rounds its result back to b's dtype
        err = rel_err(x, sptrsv_golden(l, np.asarray(b0, dtype=l.dtype)))
        extra["rel_err"] = err
        exact = method != "jacobi" or plan.sweeps >= plan.nlevels - 1
        if exact:
            tol = 1e-10 if l.dtype == np.float64 else 1e-3
            assert err < tol, f"validation failed: {err}"
        # truncated jacobi: rel_err is the reported approximation quality

    def step(b, arrs, b0):
        return b0 + _EPS * plan.apply_pure(arrs, b)

    per = measure_seconds_per_iter(step, b0, plan.device_arrays(), b0,
                                   iters_lo=max(iters // 5, 2),
                                   iters_hi=iters)
    extra["levels_per_s"] = plan.nlevels / per
    rec = BenchRecord(
        name="sptrsv", seconds_per_iter=per, flops=2.0 * l.nnz,
        bytes=plan.bytes_per_iter, extra=extra,
    )
    if compare_reference:
        ref_solve, ref_arrs, _ = sptrsv_reference_pure(l)

        def ref_step(b, arrs, b0):
            return b0 + _EPS * ref_solve(arrs, b)

        ref_per = measure_seconds_per_iter(ref_step, b0, ref_arrs, b0,
                                           iters_lo=2, iters_hi=6)
        rec.extra["jnp_reference_s"] = ref_per
        rec.extra["speedup_vs_jnp_reference"] = ref_per / per
    return rec


def bench_sptrsm(l: CSR, k: int = 8, *, validate: bool = True,
                 iters: int = 15, method: str = "auto") -> BenchRecord:
    """Multi-RHS triangular solve; one analysis amortized over k columns."""
    n = l.shape[0]
    plan = SptrsmPlan(l, method=method)
    rng = np.random.default_rng(0)
    b0 = jnp.asarray(rng.standard_normal((n, k)).astype(l.dtype))

    extra = {"nnz": l.nnz, "n": n, "k": k, "nlevels": plan.nlevels,
             "padding_ratio": plan.padding_ratio, "method": plan.method,
             "dtype": str(np.dtype(l.dtype))}
    if validate:
        x = np.asarray(plan(b0))
        err = rel_err(x, sptrsm_golden(l, np.asarray(b0)))
        extra["rel_err"] = err
        tol = 1e-10 if l.dtype == np.float64 else 1e-3
        assert err < tol, f"validation failed: {err}"

    def step(b, arrs, b0):
        return b0 + _EPS * plan.apply_pure(arrs, b)

    per = measure_seconds_per_iter(step, b0, plan.device_arrays(), b0,
                                   iters_lo=max(iters // 5, 2),
                                   iters_hi=iters)
    extra["levels_per_s"] = plan.nlevels / per
    return BenchRecord(
        name=f"sptrsm_k{k}", seconds_per_iter=per, flops=2.0 * l.nnz * k,
        bytes=plan.bytes_per_iter(k), extra=extra,
    )


def bench_dist_spmv(a: CSR, mesh=None, *, strategy: str = "nnz_balanced",
                    validate: bool = True, iters: int = 25) -> BenchRecord:
    from .parallel import DistSpmvPlan, make_mesh

    mesh = mesh or make_mesh()
    m, n = a.shape
    if m != n:
        raise ValueError("bench uses square matrices (carry feedback)")
    with jax.profiler.TraceAnnotation("retile"):
        plan = DistSpmvPlan(a, mesh, strategy=strategy)
    x0 = np.random.default_rng(0).standard_normal(n).astype(a.dtype)

    extra = {"strategy": strategy, "ndev": plan.ndev, "nnz": a.nnz, "m": m,
             "local_method": plan.local_method}
    if validate:
        y = np.asarray(plan(x0))
        err = rel_err(y, spmv_golden(a, x0))
        extra["rel_err"] = err
        assert err < default_tol(a.dtype), f"validation failed: {err}"

    with jax.profiler.TraceAnnotation("H2D"):
        xd = jnp.asarray(x0)

    def step(x, arrs, x0):
        return x0 + _EPS * plan.apply_pure(arrs, x)

    with jax.profiler.TraceAnnotation("kernel"):
        per = measure_seconds_per_iter(step, xd, plan.device_arrays(), xd,
                                       iters_lo=max(iters // 5, 2),
                                       iters_hi=iters)
    return BenchRecord(
        name=f"dist_spmv_{strategy}", seconds_per_iter=per,
        flops=2.0 * a.nnz, bytes=plan.bytes_per_iter, extra=extra,
    )
