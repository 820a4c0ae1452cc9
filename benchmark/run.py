"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (`cuvs_rag_tpu_torch/`).
The cell, its configuration and its traffic mix are found by name from
`BENCHMARK.json`. With --trace 0 the line's metrics are the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a
torch.profiler trace of the window. The last line of standard output is
one JSON object; the numbers `correct` was decided by are the last lines
of standard error and the last key of that object. Exits 2 without a
result where CUDA is missing or the cell asks for more cards than are
visible, and 3 where the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout, before torch
# is imported (the port builds its kernels into build/kernels/ itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level modules that must never be loaded, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "cuvs_rag_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import cell as cell_lib

    cell = cell_lib.find_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    run = cell_lib.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), devices=devices,
                       t_start=T_START)
    line = cell_lib.run_cell(run)
    found = forbidden_loaded()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"run {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
