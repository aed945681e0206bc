"""Timing & metrics harness (layer L4, SURVEY.md C13).

The reference times with cudaEvent around a K-iteration kernel loop. Here
every measurement runs the op as *dependent* iterations inside one jitted
``lax.fori_loop`` with a dynamic trip count (one compile) and reports the
**marginal** cost between a low and a high iteration count, so the fixed
dispatch and transfer cost of one call cancels.

GFLOP/s and GB/s come from explicit per-routine flop/byte models
(2*nnz flops for SpMV; bytes from the plan's ``bytes_per_iter``), and
bandwidth is also reported as a fraction of a STREAM triad measured on the
same device with the same harness. Every record names its device
(:func:`device_info`): a number taken on the CPU is not a device number.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def device_info() -> dict:
    """Platform, kind and count of the devices JAX computes on."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@dataclasses.dataclass
class BenchRecord:
    name: str
    seconds_per_iter: float
    flops: float = 0.0
    bytes: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds_per_iter / 1e9

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds_per_iter / 1e9

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "seconds_per_iter": self.seconds_per_iter,
            "gflops": self.gflops,
            "gbps": self.gbps,
            "device": device_info(),
            **self.extra,
        }


def measure_seconds_per_iter(
    step: Callable, init, *args, iters_lo: int = 5, iters_hi: int = 25,
    repeats: int = 3,
) -> float:
    """Marginal seconds per iteration of ``step(carry, *args) -> carry``.

    ``step`` must return something of the same structure as its carry so the
    loop carries a data dependency (prevents elision/overlap/LICM of the
    loads that depend on the carry). Thread device arrays through ``*args``
    (pytrees fine) rather than closing over them, which would embed them in
    the compiled program as constants.

    Reports the best of ``repeats`` values of (t(hi) - t(lo)) / (hi - lo),
    each run ending in ``block_until_ready``; where timer noise swamps the
    difference (a tiny op), the whole-run t(hi) / hi instead.
    """

    @jax.jit
    def run(x, k, *a):
        return lax.fori_loop(0, k, lambda i, c: step(c, *a), x)

    def timed(k):
        t0 = time.perf_counter()
        jax.block_until_ready(run(init, jnp.int32(k), *args))
        return time.perf_counter() - t0

    lo, hi = max(iters_lo, 1), max(iters_hi, iters_lo + 1)
    timed(lo)  # compile + warm
    best = float("inf")
    for _ in range(max(repeats, 1)):
        best = min(best, (timed(hi) - timed(lo)) / (hi - lo))
    if best <= 0.0:
        best = timed(hi) / hi
    return best


_STREAM_CACHE: dict = {}


def stream_bandwidth(nbytes_per_array: int = 256 * (1 << 20),
                     dtype=jnp.float32, *, fresh: bool = False) -> float:
    """Measured STREAM-triad bandwidth (GB/s) on the default device, with
    the same harness as the kernels it is compared against.

    ``fresh=True`` bypasses (and refreshes) the per-process cache — used by
    the interleaved ratio protocol, which pairs each kernel sample with an
    adjacent STREAM sample so slow device drift cancels in the ratio.
    """
    key = (nbytes_per_array, str(dtype), str(jax.devices()[0]))
    if not fresh and key in _STREAM_CACHE:
        return _STREAM_CACHE[key]
    n = nbytes_per_array // jnp.dtype(dtype).itemsize
    b = jnp.full((n,), 1.0, dtype)

    def triad(x, b):
        return x + 2.0 * b

    per = measure_seconds_per_iter(triad, jnp.zeros((n,), dtype), b,
                                   iters_lo=4, iters_hi=16, repeats=2)
    bw = 3 * n * jnp.dtype(dtype).itemsize / per / 1e9
    _STREAM_CACHE[key] = bw
    return bw
