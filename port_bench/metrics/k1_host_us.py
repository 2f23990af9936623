"""k1_host_us: K1 ``fused_moments``'s (``csrc/fused_moments.cu``) host
time a call: the mean wall of the program's ``kernel.fused_moments`` spans
on the ``cuda`` route (``parallel/kernels.py``), from the wrapper's entry
to the launch's return; the kernel runs after it.  The SanityChecker calls
it once a train."""

from port_bench.harness import attribution

SHIMS = []
KERNELS = {}


def read(rec):
    return attribution.cuda_wall_us(rec, "kernel.fused_moments")
