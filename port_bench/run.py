"""Run one cell of the port's benchmark on the machine it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the port
(``transmogrifai_tpu_torch``).  The last line of standard output is the
run's result (one JSON object); the numbers the correctness check compared
are the last lines of standard error.  The kernels the port builds go to
its own ``_build/`` directory in the checkout; any other compiler cache
goes to ``port_bench/_cache/`` there.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "port_bench" / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))


def main() -> int:
    try:
        import transmogrifai_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout ({e}): no result",
              file=sys.stderr)
        return 2
    from port_bench.harness import cell

    return cell.main(sys.argv[1:], t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
