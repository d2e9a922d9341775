#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; the program under test is ``repro_torch`` from
``src/``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each number compared
with its limit, which the last lines of standard error repeat).  Exits
non-zero, printing no result, without a CUDA card, without the program,
or when JAX or the JAX package was loaded into the process.

Every build and kernel cache stays inside the checkout, at fixed paths
under ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "portbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cell import find_cell, run_cell

    cell = find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: the program under test is missing ({ROOT / 'src' / 'repro_torch'})",
              file=sys.stderr)
        return 3
    sys.path.insert(1, str(ROOT / "src"))
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad}, which the benchmark's process must not hold",
              file=sys.stderr)
        return 4
    for name, n in result["check"].items():
        print(f"check {name} {n['value']} {n['holds']} {n['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
