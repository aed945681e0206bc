"""The Pallas-Triton level-set SpTRSV kernel, on the CPU.

The kernel runs here in interpret mode, on the same schedule arrays as the
XLA ``tiles`` route it replaces on a GPU; its compiled form is checked on
the card (``tests/test_gpu.py``, run by ``chip_smoke.py``). What the CPU
can check besides: the kernel lowers to a Triton call for CUDA, the launch
shape and padding rules, and which route ``auto`` takes on each platform.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas import datasets
from sblas.formats import csr_transpose
from sblas.golden import rel_err, sptrsm_golden
from sblas.ops.kernels import sptrsv_triton
from sblas.ops.sptrsv import SptrsvPlan, _solve_tiles
from sblas.sptrsv_schedule import build_level_schedule


def _factor(kind, dtype, unit):
    if kind == "band":
        l = datasets.lower_triangular(300, 8, bandwidth=40, seed=1,
                                      dtype=dtype, unit_diagonal=unit)
    else:
        # nested-dissection Cholesky factor: dense separator rows make the
        # schedule wide, so tiles take several column chunks
        l = datasets.cholesky_factor(datasets.poisson2d_nd(16, dtype=np.float64),
                                     dtype=dtype)
        if unit:
            s = l.to_scipy().tolil()
            s.setdiag(1.0)
            from sblas.formats import CSR

            l = CSR.from_scipy(s.tocsr()).astype(dtype)
    return l


def _kernel_solve(sched, b, wb=None, num_warps=4):
    if wb is None:
        wb, num_warps = sptrsv_triton.launch_shape(sched.tile_rows,
                                                   sched.width)
    arrs = {k: jnp.asarray(v)
            for k, v in sptrsv_triton.kernel_arrays(sched, wb).items()}
    return sptrsv_triton.solve(arrs, jnp.asarray(b), n=sched.n,
                               tile_rows=sched.tile_rows,
                               num_tiles=sched.num_tiles, wb=wb,
                               num_warps=num_warps, interpret=True)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("kind", ["band", "chol-nd"])
def test_kernel_interpret_matches_tiles(kind, lower, unit, dtype, k):
    """Same schedule, same inputs: the kernel against the tiles route and
    the scipy golden, over both sweeps, unit diagonal, f32/f64, K RHS."""
    l = _factor(kind, dtype, unit)
    if not lower:
        l = csr_transpose(l)
    n = l.shape[0]
    sched = build_level_schedule(l, lower=lower, unit_diagonal=unit)
    rng = np.random.default_rng(k)
    b = rng.standard_normal((n,) if k == 1 else (n, k)).astype(dtype)
    got = np.asarray(_kernel_solve(sched, b))
    assert got.shape == b.shape and got.dtype == dtype
    b_pad = np.concatenate([b, np.zeros((2,) + b.shape[1:], dtype)])
    ref = np.asarray(_solve_tiles(
        jnp.asarray(sched.slot_row), jnp.asarray(sched.col),
        jnp.asarray(sched.val), jnp.asarray(sched.inv_diag),
        jnp.asarray(b_pad), n, sched.tile_rows, sched.num_tiles))
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert rel_err(got, ref) < tol
    gold = sptrsm_golden(l, b.astype(np.float64), lower=lower,
                         unit_diagonal=unit)
    assert rel_err(got, gold) < (1e-10 if dtype == np.float64 else 2e-4)


@pytest.mark.parametrize("tile_rows", [8, 24, 40, 120])
def test_kernel_tile_rows(tile_rows):
    """Tile heights that are not powers of two: the lanes past tile_rows
    re-read the last row and must not overwrite it."""
    l = _factor("band", np.float64, False)
    sched = build_level_schedule(l, tile_rows=tile_rows)
    assert sched.tile_rows == tile_rows
    b = np.random.default_rng(tile_rows).standard_normal(l.shape[0])
    got = np.asarray(_kernel_solve(sched, b))
    assert rel_err(got, sptrsm_golden(l, b)) < 1e-10


@pytest.mark.parametrize("wb", [8, 16, 32])
def test_kernel_chunk_widths_agree(wb):
    """Any chunk width gives the same solution (more, narrower chunks)."""
    l = _factor("chol-nd", np.float64, False)
    sched = build_level_schedule(l)
    b = np.random.default_rng(0).standard_normal(l.shape[0])
    ref = _kernel_solve(sched, b)
    np.testing.assert_allclose(np.asarray(_kernel_solve(sched, b, wb=wb)),
                               np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_launch_shape_rule():
    # chunks as wide as the schedule, capped at 128 columns and 8192 values
    assert sptrsv_triton.launch_shape(120, 32) == (32, 4)
    assert sptrsv_triton.launch_shape(40, 560) == (128, 8)
    assert sptrsv_triton.launch_shape(512, 560) == (16, 8)
    assert sptrsv_triton.launch_shape(8, 8) == (8, 4)
    assert sptrsv_triton.launch_shape(256, 2048) == (32, 8)


def test_kernel_arrays_padding_and_chunks():
    l = _factor("chol-nd", np.float32, False)
    sched = build_level_schedule(l)
    arrs = sptrsv_triton.kernel_arrays(sched, 128)
    assert arrs["col"].shape[1] % 128 == 0
    assert arrs["col"].shape[1] >= sched.width
    # pads point at the zero slot with value 0; real entries are unchanged
    np.testing.assert_array_equal(arrs["col"][:, :sched.width], sched.col)
    assert np.all(arrs["col"][:, sched.width:] == sched.n)
    assert np.all(arrs["val"][:, sched.width:] == 0)
    deg = (sched.col != sched.n).sum(1).reshape(sched.num_tiles, -1).max(1)
    np.testing.assert_array_equal(arrs["nch"], -(-deg // 128))
    assert arrs["nch"].dtype == np.int32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_lowers_to_triton_for_cuda(dtype):
    """The kernel lowers to a Triton call for CUDA from this CPU (the GPU
    compiler itself only runs on the card)."""
    from jax import export

    l = _factor("band", dtype, False)
    sched = build_level_schedule(l)
    wb, nw = sptrsv_triton.launch_shape(sched.tile_rows, sched.width)
    arrs = {k: jnp.asarray(v)
            for k, v in sptrsv_triton.kernel_arrays(sched, wb).items()}
    f = jax.jit(functools.partial(
        sptrsv_triton.solve, n=sched.n, tile_rows=sched.tile_rows,
        num_tiles=sched.num_tiles, wb=wb, num_warps=nw))
    exp = export.export(f, platforms=("cuda",), disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
        arrs, jnp.zeros((sched.n, 4), dtype))
    text = exp.mlir_module()
    assert "xla.gpu.triton" in text and "sptrsv_levels" in text


@pytest.mark.parametrize("platform,route", [("cpu", "tiles"),
                                            ("gpu", "triton")])
def test_sptrsv_auto_route_by_platform(monkeypatch, platform, route):
    import sblas.utils.backend as be

    monkeypatch.setattr(be, "platform", lambda: platform)
    l = _factor("band", np.float32, False)
    plan = SptrsvPlan(l)
    assert plan.method == route
    from sblas.ops.sptrsm import SptrsmPlan

    assert SptrsmPlan(l).method == route


def test_triton_plan_wiring_interpret(monkeypatch):
    """A triton plan's own arrays and launch shape, run in interpret mode,
    solve correctly (the plan is built as on a GPU)."""
    import sblas.utils.backend as be

    monkeypatch.setattr(be, "platform", lambda: "gpu")
    l = _factor("chol-nd", np.float32, False)
    plan = SptrsvPlan(l)
    assert plan.method == "triton"
    b = np.random.default_rng(5).standard_normal((l.shape[0], 3)).astype(
        np.float32)
    x = sptrsv_triton.solve(plan.device_arrays(), jnp.asarray(b),
                            n=l.shape[0], tile_rows=plan.tile_rows,
                            num_tiles=plan.num_tiles, wb=plan._wb,
                            num_warps=plan._num_warps, interpret=True)
    assert rel_err(np.asarray(x), sptrsm_golden(l, b)) < 2e-4


def test_triton_route_refused_off_gpu():
    """No route runs a kernel in interpret mode: on the CPU the triton
    route is refused, not emulated."""
    l = _factor("band", np.float32, False)
    with pytest.raises(ValueError, match="needs a GPU"):
        SptrsvPlan(l, method="triton")
