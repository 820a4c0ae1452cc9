"""K1 (`ops/flat_kernels.flat_topk_exact`) timed through its wrapper at the
call shapes of the main paths and of the parity corpus, and what a call of
the K1 and K6 wrappers costs the host:

    python cuvs_rag_tpu_torch/eval/wrapper_times.py [--root DIR] [--seed 0]

CUDA-event ms of K1 at 16 queries and one over 6,290,000 x 384 bf16 rows
and over 1,000,000 x 1024 bf16 rows, and at 16 queries over 1,048,576 x 384
rows stored as fp32, bf16 and int8 (k = 10, sqeuclidean); the crossover
sweep of K1's two tensor-core kernels (`crossover`): at 1 to 128 queries
over the 6,290,000 x 384 bf16 rows and at the CLI's 100 queries over
2,000,000 x 768, the route `ops/flat_kernels.exact_plan` takes, and from 1
to 64 queries (and at the CLI's shape) both the 16-query kernel and the
wide one, each forced by moving the crossover (`_NARROW_MAX_Q`); then host
microseconds a call (`eval/roofline.host_us`: the launch still in flight)
and CUDA-event ms of K1 over 4,096 x 384 bf16 rows and of K6
(`ops/pq_kernels.pq_adc_scores`) at 16 queries x 20 probes, 48 code bytes a
row, windows of 1,280 with 400 to 1,280 live rows, where the launch path is
most of a call. Prints the card's name and power limit, then one JSON line
{"wrapper_times": {...}}. `--root` names another checkout of
the repository whose package is timed instead of this one (to compare two
trees in turns on one card); only names both trees have are used. Run it as
a file, not with -m, so that `--root` can take effect. It needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


SWEEP_QUERIES = (1, 2, 4, 8, 12, 16, 17, 20, 24, 25, 32, 40, 48, 56, 64, 80,
                 96, 100, 112, 128)
BOTH_ROUTES = range(1, 65)  # query counts timed by both kernels


def crossover(gen) -> dict:
    """{shape: {n_q: {"route": .., "ms": .., "narrow_ms": .., "wide_ms":
    ..}, "plain_ms": {n_q: ..}}}: K1 by the rule's route at each query
    count, and by both routes where BOTH_ROUTES holds it (CUDA events, 10
    calls, k = 10); its plain version at 100 queries (3 calls)."""
    import torch

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    def run(ix, x, n_q, narrow_max):
        saved, fk._NARROW_MAX_Q = fk._NARROW_MAX_Q, narrow_max
        try:
            call = (ix.vectors, ix.sqnorms, x[:n_q] + 0.01, ix.n_valid,
                    ix.scales)
            return cuda_ms(lambda: fk.flat_topk_exact(
                *call, k=10, metric="sqeuclidean"), 10)
        finally:
            fk._NARROW_MAX_Q = saved

    out = {}
    for rows, dim, counts in ((6_290_000, 384, SWEEP_QUERIES),
                              (2_000_000, 768, (100,))):
        x = torch.nn.functional.normalize(
            torch.randn((rows, dim), generator=gen, device="cuda"), dim=1)
        ix = flat.build(FlatParams(dtype="bfloat16"), x)
        sm = fk._sm_count(x.device)
        table = out[f"{rows} x {dim} bfloat16"] = {}
        call = (ix.vectors, ix.sqnorms, x[:100] + 0.01, ix.n_valid,
                ix.scales)
        table["plain_ms"] = {100: cuda_ms(
            lambda: fk.flat_topk_exact_plain(*call, k=10,
                                             metric="sqeuclidean"), 3)}
        for n_q in counts:
            row = table[n_q] = {
                "route": fk.exact_plan(rows, n_q, dim, torch.bfloat16, sm,
                                       10).route,
                "ms": run(ix, x, n_q, fk._NARROW_MAX_Q)}
            if n_q in BOTH_ROUTES or dim != 384:
                row["narrow_ms"] = run(ix, x, n_q, 1 << 30)
                row["wide_ms"] = run(ix, x, n_q, 0)
        del ix, x
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms, gpu_line, host_us
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    if not torch.cuda.is_available():
        print("wrapper_times: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}

    def time_rows(rows, dim, dtypes, query_counts):
        x = torch.nn.functional.normalize(
            torch.randn((rows, dim), generator=gen, device="cuda"), dim=1)
        for dtype in dtypes:
            ix = flat.build(FlatParams(dtype=dtype), x)
            for n_q in query_counts:
                call = (ix.vectors, ix.sqnorms, x[:n_q] + 0.01, ix.n_valid,
                        ix.scales)
                out[f"{n_q} x {rows} x {dim} {dtype}"] = cuda_ms(
                    lambda: fk.flat_topk_exact(*call, k=10,
                                               metric="sqeuclidean"), 10)
            del ix

    time_rows(6_290_000, 384, ("bfloat16",), (16, 1))
    if hasattr(fk, "exact_plan"):  # a tree with the wide kernel
        out["crossover"] = crossover(gen)
    time_rows(1_000_000, 1024, ("bfloat16",), (16, 1))
    time_rows(1 << 20, 384, ("float32", "bfloat16", "int8"), (16,))

    def launch_bound(name, fn):
        out[f"{name} host_us"] = host_us(fn)
        out[f"{name} ms"] = cuda_ms(fn, 200, 20)

    kw = dict(generator=gen, device="cuda")
    x = torch.randn((4096, 384), **kw).to(torch.bfloat16)
    sq = (x.float() ** 2).sum(1)
    launch_bound("K1 16 x 4096 x 384 bfloat16", lambda: fk.flat_topk_exact(
        x, sq, x[:16], 4096, None, k=10, metric="sqeuclidean"))
    mb, cap, window, pairs = 48, 7_900_032, 1280, (16, 20)
    k6 = (torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw),
          torch.randint(0, 1 << 22, (cap,), dtype=torch.int32, **kw),
          torch.randn(cap, **kw), torch.randn(pairs + (2 * mb, 16), **kw),
          (torch.randint(0, (cap - window) // 128, pairs, **kw) * 128).int(),
          torch.randint(400, window + 1, pairs, **kw).int(),
          torch.randn(pairs, **kw))
    launch_bound("K6 16 x 20 x 1280", lambda: pk.pq_adc_scores(
        *k6, window=window))
    print(json.dumps({"wrapper_times": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
