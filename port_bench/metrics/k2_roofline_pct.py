"""k2_roofline_pct: K2 ``bin_matrix`` (``csrc/bin_matrix.cu``) as a share
of its roofline: the least time for the bytes of every call of the traced
window (x read once, the bins written once, the edges read, at 3.35
TB/s), over the device time of its kernels in the profiler's trace,
summed over launches."""

import torch

from port_bench.harness.recorder import KernelCall
from port_bench.harness.yardsticks import bin_bound_ms, is_k2_kernel
from port_bench.harness.profile import kernel_seconds


def _describe(x, edges, out_dtype=torch.int32, *args, **kw):
    n, d = (int(v) for v in x.shape)
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    return KernelCall("bin_matrix", n, d, int(edges.shape[-1]), out_bytes)


SHIMS = []
KERNELS = {"bin_matrix": _describe}


def read(rec):
    calls = [c for c in rec.kernel_calls if c.kernel == "bin_matrix"]
    dev = kernel_seconds(rec.device_events, is_k2_kernel)
    if not calls or not dev:
        return None
    bound_ms = sum(bin_bound_ms(c.n, c.d, c.n_edges, c.out_bytes)
                   for c in calls)
    return 100.0 * bound_ms / (1e3 * dev)
