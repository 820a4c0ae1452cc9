"""Where K6's time on the device goes (`csrc/pq_adc.cu`, `pq_adc_kernel`):

    python cuvs_rag_tpu_torch/eval/k6_ablation.py [--seed 0]

Variants of the source leave one part of the kernel's work out: the table
lookups (the nibbles are added instead), the code loads (a byte is made up
from the slot and the stream), the table copy, the ids and corrections; two
more keep only the code loads or only the lookups. Their results are wrong
and are not checked. Each is launched through
`ops/pq_kernels.pq_adc_scores` and its kernel's device microseconds a launch
are read from torch.profiler over 50 launches, twice, at 16 queries x 20
probes, 48 code bytes a row, windows of 1,280 slots: with 400 to 1,280 live
rows in a 7.9M-slot layout (the main path's shape), the same with a
262,144-slot layout whose codes stay in L2, with every window full, and
with 64 queries. Prints the card's name and power limit, then one JSON line
{"k6_ablation": {shape: {variant: [us, us]}}}. It needs a CUDA device and
fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LOOKUPS = ("      lo += l0[b & 15u];\n      hi += l0[mb * 16 + (b >> 4)];",
           "      lo += (float)(b & 15u);\n      hi += (float)(b >> 4);")
LOADS = ("      const unsigned b = *c;",
         "      const unsigned b = (unsigned)(s * 37 + j) & 255u;")
TABLE = ("  for (int i = threadIdx.x; i < lut_n; i += THREADS) lut[i] = src[i];",
         "  if (threadIdx.x == 0) lut[0] = src[0];")
IDS = ("    const int id = j < cnt ? row_ids[slot] : -1;",
       "    const int id = j < cnt ? j : -1;")
CORR = ("    if (corr != nullptr) v -= corr[slot];", "")
LEFT_OUT = {
    "shipped": [], "no_lookups": [LOOKUPS], "no_code_loads": [LOADS],
    "no_table_copy": [TABLE, LOOKUPS], "no_ids_corr": [IDS, CORR],
    "only_code_loads": [LOOKUPS, TABLE, IDS, CORR],
    "only_lookups": [LOADS, IDS, CORR],
}
MB, WINDOW = 48, 1280
# name: (slots of the layout, queries, fewest live rows of a window)
SHAPES = {"7.9M slots, 400-1280 live": (7_900_032, 16, 400),
          "262,144 slots (codes in L2)": (262_144, 16, 400),
          "7.9M slots, full windows": (7_900_032, 16, WINDOW),
          "7.9M slots, 64 queries": (7_900_032, 64, 400)}


def variants(source: str) -> dict:
    """{name: source text with that work left out}."""
    out = {}
    for name, subs in LEFT_OUT.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from cuvs_rag_tpu_torch.eval.ring_sweep import build_variants
    from cuvs_rag_tpu_torch.eval.roofline import device_ms, gpu_line
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk

    if not torch.cuda.is_available():
        print("k6_ablation: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    paths = build_variants("pq_adc.cu", "k6_ablation",
                           variants((build.CSRC / "pq_adc.cu").read_text()))

    kw = dict(generator=torch.Generator(device="cuda").manual_seed(args.seed),
              device="cuda")
    out = {}
    for shape, (cap, n_q, fewest) in SHAPES.items():
        pairs = (n_q, 20)
        call = (torch.randint(0, 256, (MB, cap), dtype=torch.uint8, **kw),
                torch.randint(0, 1 << 22, (cap,), dtype=torch.int32, **kw),
                torch.randn(cap, **kw), torch.randn(pairs + (2 * MB, 16), **kw),
                (torch.randint(0, (cap - WINDOW) // 128, pairs, **kw) * 128).int(),
                torch.randint(fewest, WINDOW + 1, pairs, **kw).int(),
                torch.randn(pairs, **kw))
        out[shape] = {}
        for name, path in paths.items():
            with mock.patch.object(pk, "_SOURCE", path):
                pk.pq_adc_scores(*call, window=WINDOW)
                torch.cuda.synchronize()
                out[shape][name] = [1e3 * device_ms(
                    lambda: pk.pq_adc_scores(*call, window=WINDOW),
                    ("pq_adc_kernel",), 50)["pq_adc_kernel"] for _ in range(2)]
    print(json.dumps({"k6_ablation": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
