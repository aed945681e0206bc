from .timing import (measure_seconds_per_iter, stream_bandwidth, BenchRecord,
                     device_info)

__all__ = ["measure_seconds_per_iter", "stream_bandwidth", "BenchRecord",
           "device_info"]
