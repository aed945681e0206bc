"""`sblas-bench` CLI (layer L5, SURVEY.md C14).

Mirrors the reference's per-routine driver executables
(`./spmv matrix.mtx ngpu iters` style) as argparse subcommands with JSON
output, golden validation, and optional profiler traces:

    sblas-bench spmv   --matrix cant --dtype f32 --method ell --json out.json
    sblas-bench spmm   --matrix consph --k 32
    sblas-bench sptrsv --matrix chol:poisson:64 --compare-reference
    sblas-bench sptrsm --matrix chol:cant --k 8
    sblas-bench dist-spmv --matrix cant --strategy nnz_split
    sblas-bench stream
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_matrix(spec: str, scale: float, dtype):
    """Resolve a matrix spec: a .mtx path, a SUITE name, a generator spec
    ('poisson:N', 'band:N:W', 'tri:N:D', 'chol:NAME'), or 'random:M:D'."""
    from . import datasets

    if spec.startswith("poisson:"):
        return datasets.poisson2d(int(spec.split(":")[1]), dtype=dtype)
    if spec.startswith("band:"):
        _, n, w = spec.split(":")
        return datasets.banded(int(n), int(w), dtype=dtype)
    if spec.startswith("tri:"):
        parts = spec.split(":")
        n, d = int(parts[1]), float(parts[2])
        return datasets.lower_triangular(n, d, dtype=dtype)
    if spec.startswith("chol:"):
        # No silent substitution: a benchmark labeled chol:X must measure a
        # real Cholesky factor or fail loudly.
        base = spec.split(":", 1)[1]
        a = _load_matrix(base, scale, np.float64)
        return datasets.cholesky_factor(a, dtype=dtype)
    if spec.startswith("random:"):
        parts = spec.split(":")
        m, d = int(parts[1]), float(parts[2])
        skew = float(parts[3]) if len(parts) > 3 else 0.0
        return datasets.random_csr(m, m, d, skew=skew, dtype=dtype)
    return datasets.load(spec, scale=scale, dtype=dtype)


def _dtype(s: str):
    return {"f32": np.float32, "f64": np.float64,
            "float32": np.float32, "float64": np.float64}[s]


def _emit(rec, args):
    d = rec.as_dict()
    line = json.dumps(d)
    print(line)
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def _maybe_profile(args):
    if getattr(args, "profile", None):
        import jax

        return jax.profiler.trace(args.profile)
    import contextlib

    return contextlib.nullcontext()


def main(argv=None):
    p = argparse.ArgumentParser(prog="sblas-bench",
                                description="sparse BLAS benchmarks")
    p.add_argument("--x64", action="store_true",
                   help="enable jax x64 (required for f64)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="pin the jax platform (records name the device)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, tri=False):
        sp.add_argument("--matrix", default="tri:20000:8" if tri else "cant",
                        help=".mtx path | SUITE name | generator spec")
        sp.add_argument("--scale", type=float, default=1.0)
        sp.add_argument("--dtype", default="f32", type=str)
        sp.add_argument("--iters", type=int, default=25)
        sp.add_argument("--no-validate", action="store_true")
        sp.add_argument("--json", default=None, help="append JSON result here")
        sp.add_argument("--profile", default=None,
                        help="write a jax.profiler trace to this dir")

    sp = sub.add_parser("spmv")
    common(sp)
    sp.add_argument("--method", default="auto",
                    choices=["auto", "coo", "ell", "bucket", "bsr"])

    sp = sub.add_parser("spmm")
    common(sp)
    sp.add_argument("--k", type=int, default=8)
    sp.add_argument("--method", default="auto",
                    choices=["auto", "ell", "bucket", "bsr", "spmv_passes"])

    sp = sub.add_parser("sptrsv")
    common(sp, tri=True)
    sp.add_argument("--tile-rows", type=int, default=0)
    sp.add_argument("--method", default="auto",
                    choices=["auto", "tiles", "triton", "jacobi"])
    sp.add_argument("--sweeps", type=int, default=None,
                    help="jacobi only: sweep count (default exact = "
                         "nlevels-1); fewer = truncated preconditioner-"
                         "grade solve, rel_err reported")
    sp.add_argument("--compare-reference", action="store_true",
                    help="also time the naive jnp masked wavefront")

    sp = sub.add_parser("sptrsm")
    common(sp, tri=True)
    sp.add_argument("--k", type=int, default=8)

    sp = sub.add_parser("dist-spmv")
    common(sp)
    sp.add_argument("--strategy", default="nnz_balanced",
                    choices=["even_rows", "nnz_balanced", "nnz_split"])
    sp.add_argument("--chips", type=int, default=0, help="0 = all devices")
    sp.add_argument("--mesh2d", default=None, metavar="RxC",
                    help="use the 2D plan on an RxC mesh (e.g. 2x4): x "
                         "sharded over cols + psum, no all_gather")

    sp = sub.add_parser("solve")
    common(sp)
    sp.add_argument("--solver", default="cg",
                    choices=["cg", "bicgstab", "gmres"])
    sp.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "ichol", "ilu"])
    sp.add_argument("--trsv-sweeps", type=int, default=None,
                    help="ichol/ilu: apply triangular solves as N jacobi "
                         "sweeps (bandwidth-bound) instead of exactly")
    sp.add_argument("--tol", type=float, default=1e-6)
    sp.add_argument("--maxiter", type=int, default=2000)

    sp = sub.add_parser("stream")
    sp.add_argument("--json", default=None)

    args = p.parse_args(argv)

    import jax

    if args.platform:
        # before any device API call, or the default platform is fixed
        jax.config.update("jax_platforms", args.platform)
    if args.x64 or getattr(args, "dtype", "f32") in ("f64", "float64"):
        jax.config.update("jax_enable_x64", True)

    from . import bench_lib
    from .utils.timing import stream_bandwidth, BenchRecord

    if args.cmd == "stream":
        bw = stream_bandwidth()
        rec = BenchRecord("stream_triad", 1.0, bytes=bw * 1e9)
        _emit(rec, args)
        return 0

    dtype = _dtype(args.dtype)
    mat = _load_matrix(args.matrix, args.scale, dtype)
    validate = not args.no_validate

    with _maybe_profile(args):
        if args.cmd == "spmv":
            rec = bench_lib.bench_spmv(mat, method=args.method,
                                       validate=validate, iters=args.iters)
        elif args.cmd == "spmm":
            rec = bench_lib.bench_spmm(mat, args.k, method=args.method,
                                       validate=validate, iters=args.iters)
        elif args.cmd == "sptrsv":
            rec = bench_lib.bench_sptrsv(
                mat, validate=validate, iters=args.iters,
                compare_reference=args.compare_reference,
                tile_rows=args.tile_rows, method=args.method,
                sweeps=args.sweeps)
        elif args.cmd == "solve":
            import time as _time

            from . import solvers
            from .golden import rel_err as _rel_err

            rng = np.random.default_rng(0)
            b = rng.standard_normal(mat.shape[0]).astype(mat.dtype)
            sw = args.trsv_sweeps
            M = {"none": None,
                 "jacobi": lambda: solvers.jacobi(mat),
                 "ichol": lambda: solvers.ichol(mat, trsv_sweeps=sw),
                 "ilu": lambda: solvers.ilu(mat, trsv_sweeps=sw)}[args.precond]
            M = M() if M else None
            fn = {"cg": solvers.cg, "bicgstab": solvers.bicgstab,
                  "gmres": solvers.gmres}[args.solver]
            fn(mat, b, tol=args.tol, maxiter=2, M=M)  # compile warmup
            t0 = _time.perf_counter()
            x, info = fn(mat, b, tol=args.tol, maxiter=args.maxiter, M=M)
            dt = _time.perf_counter() - t0
            err = float(np.linalg.norm(
                mat.to_scipy() @ np.asarray(x, dtype=np.float64)
                - b.astype(np.float64)) / np.linalg.norm(b))
            rec = BenchRecord(
                name=f"{args.solver}_{args.precond}",
                seconds_per_iter=dt / max(info["iterations"], 1),
                flops=2.0 * mat.nnz * info["iterations"],
                extra={"iterations": info["iterations"],
                       "rel_residual": info["rel_residual"],
                       "true_rel_err": err, "solve_seconds": dt},
            )
        elif args.cmd == "sptrsm":
            rec = bench_lib.bench_sptrsm(mat, args.k, validate=validate,
                                         iters=args.iters)
        elif args.cmd == "dist-spmv":
            if args.mesh2d:
                from .parallel import Dist2DSpmvPlan, make_mesh2d
                from .golden import spmv_golden, rel_err

                import jax as _jax
                import jax.numpy as jnp

                from .utils.timing import measure_seconds_per_iter

                r, c = (int(v) for v in args.mesh2d.lower().split("x"))
                plan = Dist2DSpmvPlan(mat, make_mesh2d(r, c))
                x = np.random.default_rng(0).standard_normal(
                    mat.shape[1]).astype(mat.dtype)
                err = rel_err(np.asarray(plan(x)), spmv_golden(mat, x))
                n = mat.shape[1]
                x_pad0 = jnp.zeros(plan.n_pad,
                                   plan.dtype).at[:n].set(jnp.asarray(x))
                x_pad0 = _jax.device_put(x_pad0, plan._x_sharding)

                def step(xp, arrs, x0):
                    yv = plan._run(arrs, xp)
                    return x0 + 1e-30 * jnp.pad(
                        yv, (0, plan.n_pad - mat.shape[0]))[: plan.n_pad]

                per = measure_seconds_per_iter(step, x_pad0, plan._arrs,
                                               x_pad0, iters_lo=2,
                                               iters_hi=args.iters)
                rec = BenchRecord(
                    name=f"dist_spmv2d_{r}x{c}", seconds_per_iter=per,
                    flops=2.0 * mat.nnz, bytes=plan.bytes_per_iter,
                    extra={"rel_err": float(err), "grid": args.mesh2d,
                           "local_method": plan.local_method},
                )
            else:
                from .parallel import make_mesh

                mesh = make_mesh(args.chips or None)
                rec = bench_lib.bench_dist_spmv(
                    mat, mesh, strategy=args.strategy, validate=validate,
                    iters=args.iters)
        else:
            raise SystemExit(f"unknown cmd {args.cmd}")
    rec.extra["matrix"] = args.matrix
    _emit(rec, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
