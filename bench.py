"""Single-cell SpMV benchmark: prints ONE JSON line.

Cell: cant-shaped f32 SpMV (emulated — generated from a seed) under the
auto route, validated against the scipy golden, reported as seconds per
iteration, GB/s by the plan's bytes model, and as a percentage of a
STREAM-triad bandwidth measured on the same device in the same process.

Runs in one process on a GPU and exits non-zero on any failure; it refuses
to run on the CPU, whose numbers would not describe the device.

    python bench.py
"""

import json
import sys


def main() -> int:
    import jax
    import numpy as np

    from sblas import datasets
    from sblas.bench_lib import bench_spmv
    from sblas.utils.backend import platform, use_compile_cache

    if platform() != "gpu":
        print("bench.py: no GPU found", file=sys.stderr)
        return 1
    use_compile_cache()
    rec = bench_spmv(datasets.emulate("cant", dtype=np.float32),
                     validate=True, iters=25, ratio_pairs=5)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "spmv_bw_utilization_cant_f32",
        "value": round(rec.extra["pct_stream"], 2),
        "unit": "% of measured STREAM-triad BW",
        "detail": {
            "gbps": rec.gbps,
            "stream_gbps": rec.extra["stream_gbps"],
            "seconds_per_iter": rec.seconds_per_iter,
            "method": rec.extra["method"],
            "rel_err_vs_scipy": rec.extra["rel_err"],
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
