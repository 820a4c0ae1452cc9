"""SQ8 int8 against bf16 flat search at 2M x 768.

    python -m cuvs_rag_tpu_torch.scripts.bench_int8_flat [--device cuda]

Also the id agreement of int8 with the bf16 ranking at k = 5: the recall
cost of halving the bytes read. Times are CUDA events over 20 distinct
batches of 100 (common.time_batches).
"""

from __future__ import annotations

import argparse
import time

from cuvs_rag_tpu_torch.scripts import common

N, D, K, BATCH, REPS = 2_000_000, 768, 5, 100, 20
SEED = 42


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    return p.parse_args(argv)


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    geo = common.Gaussian(args.dim)
    corpus = common.make_corpus(SEED, args.n, geo, dev)
    print("corpus ready", flush=True)
    qrs = [common.make_queries(SEED, 100 + r, BATCH, geo, dev)
           for r in range(REPS)]

    results = {}
    for dtype in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        ix = flat.build(FlatParams(dtype=dtype, tile_n=8192), corpus)
        common.sync(dev)
        print(f"{dtype} build {time.perf_counter()-t0:.1f}s", flush=True)
        t = common.time_batches(lambda q: flat.search(None, ix, q, K), qrs)
        gbps = ix.vectors.nbytes / t / 1e9
        d, ids = flat.search(None, ix, qrs[0], K)
        if hold and dtype == "bfloat16":
            hold("bf16", corpus, qrs[0], d, ids)
        results[dtype] = (t, ids.cpu().numpy())
        print(f"{dtype}: {t*1e3:.3f} ms/batch  {t/BATCH*1e3:.4f} ms/q  "
              f"{gbps:.0f} GB/s", flush=True)
        del ix

    agree = common.recall(results["int8"][1], results["bfloat16"][1], K)
    speedup = results["bfloat16"][0] / results["int8"][0]
    print(f"int8 vs bf16 id agreement@{K}: {agree:.4f}", flush=True)
    print(f"speedup int8/bf16: {speedup:.2f}x", flush=True)
    return {"bf16_ms": results["bfloat16"][0] * 1e3,
            "int8_ms": results["int8"][0] * 1e3, "agreement": agree,
            "speedup": speedup}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
