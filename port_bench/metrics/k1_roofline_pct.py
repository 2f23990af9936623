"""k1_roofline_pct: K1 ``fused_moments`` (``csrc/fused_moments.cu``) as a
share of its roofline: the least time for the bytes of every call of the
traced window (x and y read once, 5d + 2 floats written, at 3.35 TB/s),
over the device time of its kernels in the profiler's trace, summed over
launches."""

from port_bench.harness.recorder import KernelCall
from port_bench.harness.yardsticks import is_k1_kernel, moments_bound_ms
from port_bench.harness.profile import kernel_seconds


def _describe(x, y, *args, **kw):
    return KernelCall("fused_moments", int(x.shape[0]), int(x.shape[1]))


SHIMS = []
KERNELS = {"fused_moments": _describe}


def read(rec):
    calls = [c for c in rec.kernel_calls if c.kernel == "fused_moments"]
    dev = kernel_seconds(rec.device_events, is_k1_kernel)
    if not calls or not dev:
        return None
    bound_ms = sum(moments_bound_ms(c.n, c.d) for c in calls)
    return 100.0 * bound_ms / (1e3 * dev)
