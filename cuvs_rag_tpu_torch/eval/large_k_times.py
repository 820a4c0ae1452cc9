"""K3 (`ops/flat_kernels.flat_topk_large`) and K5
(`ops/ivf_kernels.ivf_scan_large`) timed through their wrappers at the main
paths' shapes, at one query and at 16:

    python cuvs_rag_tpu_torch/eval/large_k_times.py [--root DIR] [--seed 0]

K3 over 6,290,000 x 384 bf16 unit rows at k = 2,000 (tile_c 1,024, R = 12);
K5 over a sorted layout of the same rows cut into lists of 500 to 2,048 rows
(window 2,048, R = 10), each query probing 20 of them at k = 2,000; and the
searches that run them, flat and IVF-Flat (default params, 20 probes) built
over those rows, 16 queries at k = 2,000. Each call is timed by CUDA events around 10 calls ("ms") and by torch.profiler,
as the device time of its kernels ("device_ms": every kernel whose name
holds "topr", which both trees' K3 and K5 kernels and their merge do).
Where the tree has K3's plan override (`_TOPR_BLOCKS_PER_SM`), K3 is timed
at its rule and at one and two blocks an SM too, and the plans must give
the same scores and certificates. Prints the card's name and power limit,
then one JSON line {"large_k_times": {...}}. `--root` names another
checkout of the repository whose package is timed instead of this one (to
compare two trees in turns on one card). Run it as a file, not with -m, so
that `--root` can take effect. It needs a CUDA device and fails without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROWS, DIM, K, PROBES, WINDOW = 6_290_000, 384, 2000, 20, 2048


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("large_k_times: CUDA is not available", file=sys.stderr)
        return 1
    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms, device_ms, gpu_line
    from cuvs_rag_tpu_torch.index import flat, ivf_flat
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.config import FlatParams, IVFFlatParams

    print(gpu_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.nn.functional.normalize(
        torch.randn((ROWS, DIM), generator=gen, device="cuda"), dim=1)
    v = x.to(torch.bfloat16)
    sq = (v.float() ** 2).sum(1)
    out = {}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        out[name] = {"ms": cuda_ms(fn, 10),
                     "device_ms": sum(device_ms(fn, ("topr",), 20).values())}

    # the searches that run K3 and K5: flat and IVF-Flat (20 probes) at
    # k = 2,000, 16 queries near corpus rows
    q16 = x[:16] + 0.01
    index = flat.build(FlatParams(dtype="bfloat16"), x)
    timed(f"flat search 16 x k = {K}",
          lambda: flat.search(None, index, q16, K))
    index = ivf_flat.build(IVFFlatParams(dtype="bfloat16"), x)
    timed(f"ivf_flat search 16 x k = {K}",
          lambda: ivf_flat.search(None, index, q16, K))
    del index, x

    # K3: queries near corpus rows
    for n_q in (1, 16):
        q = v[:n_q].float() + 0.01
        call = (v, sq, q, ROWS, None)
        kw = dict(k=K, metric="sqeuclidean")
        timed(f"K3 {n_q} x {ROWS} x {DIM} bf16",
              lambda: fk.flat_topk_large(*call, **kw))
        if hasattr(fk, "_TOPR_BLOCKS_PER_SM"):
            want = fk.flat_topk_large(*call, **kw)
            for blocks in (1, 2):
                with mock.patch.object(fk, "_TOPR_BLOCKS_PER_SM", blocks):
                    got = fk.flat_topk_large(*call, **kw)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[2], want[2])):
                        raise AssertionError(f"K3 at {blocks} blocks an SM "
                                             "differs from its rule")
                    timed(f"K3 {n_q} x {ROWS} x {DIM} bf16, {blocks} blocks an SM",
                          lambda: fk.flat_topk_large(*call, **kw))

    # K5: lists of 500 to 2,048 rows over the same rows, 20 probed a query
    counts = torch.randint(500, WINDOW + 1, (ROWS // 1000,), generator=gen,
                           device="cuda")
    counts = counts[:int((torch.cumsum(counts, 0) <= ROWS).sum())]
    offsets = torch.cumsum(counts, 0) - counts
    ones = torch.ones(ROWS, device="cuda")
    n_sub, r_planes = ik.large_k_config(WINDOW, DIM, K)
    for n_q in (1, 16):
        probes = torch.randint(0, counts.numel(), (n_q, PROBES), generator=gen,
                               device="cuda")
        q = v[offsets[probes[:, 0]]].float() + 0.01
        call = (v, sq, ones, q, offsets[probes].int(), counts[probes].int())
        kw = dict(k=K, window=WINDOW, metric="sqeuclidean", n_sub=n_sub,
                  r_planes=r_planes)
        timed(f"K5 {n_q} x {PROBES} probes, window {WINDOW}",
              lambda: ik.ivf_scan_large(*call, **kw))
        out[f"K5 {n_q} x {PROBES} probes, window {WINDOW}"]["rows"] = int(
            counts[probes].clamp(max=WINDOW).sum())
    print(json.dumps({"large_k_times": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
