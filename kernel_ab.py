"""A/B timing of the hand-written CUDA kernels on one card.

    python3 kernel_ab.py times LABEL
    python3 kernel_ab.py routes

``times`` times K1 (``fused_moments``) and K2 (``bin_matrix``) cold and
warm (``chip_smoke.measure``) at the shapes their redesign for small
inputs and wide rows must not slow down and at the shapes it targets, with
the kernels of the tree in the working directory, on card data made from a
seed, and prints one line ``AB {"label": LABEL, "rows": [...]}``.  To
compare two commits, unpack the other one into a directory that
``.gitignore`` lists and run it there in the same call, in turns::

    git archive <commit> | tar -x -C _archive/parent
    (cd _archive/parent && python3 ../../kernel_ab.py times parent)
    python3 kernel_ab.py times change   # and again, then the parent again

``routes`` times K2's ring and small routes forced
(``kernels.bin_matrix_on_route``) beside the launch plan's own choice at
the shapes on each side of the plan's limits (the head comment of
``csrc/bin_matrix.cu``), in the order ring, small, plan, plan, small,
ring, each held against the plain version first, and prints a line
``ROUTES {"shape": ..., "ring": [...], "small": [...], "plan": [...]}``
a shape (cold ms; ``*_warm`` warm).  Both modes import no JAX and need
one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

K1_SHAPES = [(10_000_000, 39), (1_000_000, 9), (1_000_000, 11), (1_000_000, 15),
             (500_000, 39), (180_000, 15), (60_000, 15), (1_000_000, 538),
             (200_000, 538), (10_000, 4243), (1_000, 257)]
K2_SHAPES = [(10_000_000, 39), (1_000_000, 39), (1_000_000, 9), (900_000, 7),
             (300_000, 7), (1_000_000, 1), (180_000, 9), (60_000, 9),
             (8952, 1), (128, 7), (1, 7)]
#: K2's route limits: edge-table words staged in all (7, 9, 15, 39 and
#: 1 columns) and a wave (60, 100, 256, 538 columns), with the serving
#: and 10M x 39 shapes
ROUTE_SHAPES = [(4_000_000, 7), (7_000_000, 7), (2_500_000, 9), (4_000_000, 9),
                (10_000_000, 9), (1_000_000, 15), (1_157_000, 15),
                (1_500_000, 15), (100_000, 39), (171_113, 39), (171_114, 39),
                (250_000, 39), (10_000_000, 39), (250_000_000, 1),
                (270_000_000, 1), (18_100, 60), (25_000, 60), (10_000, 100),
                (11_000, 100), (20_000, 100), (3_000, 256), (3_200, 256),
                (750, 538), (760, 538), (1, 7), (128, 7), (16_384, 7)]


def card_inputs(kname: str, shape, gen):
    """x and y (K1) or x and sorted edge rows, 31 a column (K2), on the card."""
    n, d = shape
    x = torch.randn((n, d), generator=gen, device="cuda")
    if kname == "fused_moments":
        return x, torch.rand(n, generator=gen, device="cuda")
    edges = torch.randn((d, 31), generator=gen, device="cuda")
    return x, torch.sort(edges, dim=1).values.contiguous()


def timed_rows(cs, kernels, kname: str, shapes) -> list:
    """[kernel, n, d, cold ms, warm ms] at each shape; every shape is held
    against the plain version first."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows = []
    for shape in shapes:
        args = card_inputs(kname, shape, gen)
        if kname == "fused_moments":
            cs.check_moments(kernels, *args)
            t = cs.measure(kernels.fused_moments, *args)
        else:
            cs.check_bins(kernels, *args, torch.int8)
            t = cs.measure(kernels.bin_matrix, *args, torch.int8)
        rows.append([kname, *shape, round(t["ms"], 5), round(t["ms_warm"], 5)])
        del args
    return rows


def times_main(label: str) -> int:
    import chip_smoke as cs
    from transmogrifai_tpu_torch.parallel import kernels

    kernels.build()
    rows = (timed_rows(cs, kernels, "fused_moments", K1_SHAPES)
            + timed_rows(cs, kernels, "bin_matrix", K2_SHAPES))
    print("AB " + json.dumps({"label": label, "rows": rows}), flush=True)
    return 0


def routes_main() -> int:
    import chip_smoke as cs
    from transmogrifai_tpu_torch.parallel import kernels

    kernels.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    calls = {
        "ring": lambda x, e: kernels.bin_matrix_on_route(x, e, torch.int8,
                                                         "ring"),
        "small": lambda x, e: kernels.bin_matrix_on_route(x, e, torch.int8,
                                                          "small"),
        "plan": lambda x, e: kernels.bin_matrix(x, e, torch.int8),
    }
    for shape in ROUTE_SHAPES:
        x, edges = card_inputs("bin_matrix", shape, gen)
        want = kernels.bin_matrix_plain(x, edges, torch.int8)
        row = {"shape": list(shape)}
        for name in ("ring", "small", "plan", "plan", "small", "ring"):
            assert torch.equal(calls[name](x, edges), want), (name, shape)
            t = cs.measure(calls[name], x, edges)
            row.setdefault(name, []).append(round(t["ms"], 5))
            row.setdefault(name + "_warm", []).append(round(t["ms_warm"], 5))
        print("ROUTES " + json.dumps(row), flush=True)
        del x, edges, want
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if len(sys.argv) == 3 and sys.argv[1] == "times":
        return times_main(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "routes":
        return routes_main()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
