"""k2_host_us: K2 ``bin_matrix``'s (``csrc/bin_matrix.cu``) host time a
call: the mean wall of the program's ``kernel.bin_matrix`` spans on the
``cuda`` route (``parallel/kernels.py``), from the wrapper's entry to the
launch's return; the kernel runs after it."""

from port_bench.harness import attribution

SHIMS = []
KERNELS = {}


def read(rec):
    return attribution.cuda_wall_us(rec, "kernel.bin_matrix")
