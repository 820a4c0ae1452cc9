"""Scaling stress test — the reference's breaking-point harness as a script.

The counterpart of the JAX package's `examples/stress_test.py`
(cuVS_Scaling_Stress_Test.ipynb#cell12-17: sizes 500k..2M, build each index
type, measure build/search, break at first failure, pandas summary; the
multi-GPU variant cuVS-2GPU.ipynb#cell15-20) — plus recall@10 against the
exact oracle at every size. Drives eval/bench.scaling_stress: the corpus
of each size is made on the device, times are CUDA events.

    python cuvs_rag_tpu_torch/examples/stress_test.py --sizes 100000 250000 500000
    python cuvs_rag_tpu_torch/examples/stress_test.py --sharded --positions 4 --csv out.csv
    python cuvs_rag_tpu_torch/examples/stress_test.py --device cpu --sizes 512 --dim 16
"""

import argparse
import csv
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from cuvs_rag_tpu_torch.eval import bench as bench_lib
from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh
from cuvs_rag_tpu_torch.utils.config import (
    CagraParams, CagraSearchParams, FlatParams, IVFFlatParams,
    IVFFlatSearchParams, IVFPQParams, IVFPQSearchParams,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="ivf_flat",
                   choices=["flat", "ivf_flat", "ivf_pq", "cagra"])
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[100_000, 250_000, 500_000, 1_000_000, 2_000_000])
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--chunked", action="store_true",
                   help="memory-optimized protocol: build_from_chunks with "
                        "regenerated device chunks — only the index layout "
                        "is ever resident (MEMORY_OPTIMIZED#cell13 parity)")
    p.add_argument("--no-recall", action="store_true",
                   help="skip exact-GT recall (faster at large sizes)")
    p.add_argument("--dtype", default="auto",
                   help="storage dtype for flat/ivf_flat (auto keeps the "
                        "corpus dtype; int8 probes the SQ8 capacity limit)")
    p.add_argument("--csv", default="")
    p.add_argument("--device", default=None,
                   help="default: the card (every visible card --sharded)")
    p.add_argument("--positions", type=int, default=1,
                   help="mesh positions on --device when --sharded")
    args = p.parse_args(argv)

    make_params = {
        "flat": lambda n: FlatParams(dtype=args.dtype),
        "ivf_flat": lambda n: IVFFlatParams(dtype=args.dtype),
        "ivf_pq": lambda n: IVFPQParams(),
        "cagra": lambda n: CagraParams(),
    }[args.family]
    sp = {
        "flat": lambda n: None,
        "ivf_flat": lambda n: IVFFlatSearchParams(n_probes=20),
        "ivf_pq": lambda n: IVFPQSearchParams(n_probes=20),
        "cagra": lambda n: CagraSearchParams(),
    }[args.family]
    dmesh = None
    if args.sharded:
        dmesh = DeviceMesh() if args.device is None \
            else DeviceMesh([args.device] * args.positions)

    rows = bench_lib.scaling_stress(
        args.family, make_params, args.sizes, args.dim,
        search_params_fn=sp, sharded=args.sharded, chunked=args.chunked,
        eval_recall=not args.no_recall, dmesh=dmesh, device=args.device,
    )
    print(bench_lib.format_table(rows))
    breaking = next((r.n_vectors for r in rows if not r.ok), None)
    print(f"\nbreaking point: {breaking or 'none reached'}")

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=[x.name for x in dataclasses.fields(rows[0])])
            w.writeheader()
            for r in rows:
                w.writerow(dataclasses.asdict(r))
        print(f"wrote {args.csv}")
    return rows


if __name__ == "__main__":
    main()
