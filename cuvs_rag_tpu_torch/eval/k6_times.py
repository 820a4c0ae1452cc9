"""K6 (`ops/pq_kernels.pq_adc_scores`) and the IVF-PQ search around it, timed
on the card, for one checkout of the repository:

    python3 cuvs_rag_tpu_torch/eval/k6_times.py [--root DIR] [--seed 0]

K6 at 16 queries x 20 probes, 48 code bytes a row, windows of 1,280 with
400 to 1,280 live rows in a 7,900,032-slot layout (the main path's shape),
and at 100 queries x 20 probes, 96 code bytes a row (the CLI's pq_dim) in a
2,100,096-slot layout: its kernel's device microseconds a launch
(torch.profiler over 50 launches, three times), the wrapper's host
microseconds a call (`eval/roofline.host_us`) and CUDA-event ms a call back
to back. Then `ivf_pq.search` over an IVF-PQ index at default params of
ROWS clustered rows of D (`chip_smoke.py`'s corpus and queries, made on the
card from the seed) at 20 probes, k = 10, refine_ratio 2 and 64: device ms,
kernels and host ms a call (`chip_smoke.profile_calls`) and CUDA-event ms a
batch. `--root` names another
checkout whose package and smoke script are timed instead of this one (to
compare two trees in turns on one card). Prints the card's name and power
limit, then one JSON line {"k6_times": {...}}. It needs a CUDA device and
fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as smoke
    from cuvs_rag_tpu_torch.eval.roofline import (cuda_ms, device_ms, gpu_line,
                                                  host_us)
    from cuvs_rag_tpu_torch.index import ivf_pq
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk
    from cuvs_rag_tpu_torch.utils.config import IVFPQParams, IVFPQSearchParams

    if not torch.cuda.is_available():
        print("k6_times: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kw = dict(generator=gen, device="cuda")
    out = {"root": os.path.abspath(args.root)}
    window = 1280
    for name, mb, cap, pairs in (("16 x 20, pq_dim 48", 48, 7_900_032, (16, 20)),
                                 ("100 x 20, pq_dim 96", 96, 2_100_096,
                                  (100, 20))):
        call = (torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw),
                torch.randint(0, 1 << 22, (cap,), dtype=torch.int32, **kw),
                torch.randn(cap, **kw), torch.randn(pairs + (2 * mb, 16), **kw),
                (torch.randint(0, (cap - window) // 128, pairs, **kw)
                 * 128).int(),
                torch.randint(400, window + 1, pairs, **kw).int(),
                torch.randn(pairs, **kw))
        fn = lambda: pk.pq_adc_scores(*call, window=window)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        out[name] = {
            "device_us": [1e3 * device_ms(fn, ("pq_adc_kernel",), 50)[
                "pq_adc_kernel"] for _ in range(3)],
            "host_us": host_us(fn),
            "ms": cuda_ms(fn, 200, 20),
            "bound_ms": smoke.pq_bound(*call, window=window)["bound_ms"]}
        del call
    torch.cuda.empty_cache()

    centres = smoke.make_centres(gen, "cuda")
    x = smoke.clustered_rows(smoke.ROWS, centres, gen, "cuda")
    q = x[:smoke.BATCH] + 0.02 * smoke.make_rows(smoke.BATCH, smoke.D, gen,
                                                 "cuda")
    ix = ivf_pq.build(IVFPQParams(), x, seed=args.seed)
    del x
    torch.cuda.synchronize()
    for refine in (2, 64):
        sp = IVFPQSearchParams(n_probes=smoke.N_PROBES, refine_ratio=refine)
        fn = lambda: ivf_pq.search(sp, ix, q, 10)  # noqa: E731
        prof = smoke.profile_calls(fn)
        out[f"search refine {refine}"] = {
            "ms": cuda_ms(fn, 20), **{k: prof[k] for k in (
                "host_ms_per_call", "device_ms_per_call",
                "device_kernels_per_call", "top_kernels_ms")}}
    print(json.dumps({"k6_times": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
