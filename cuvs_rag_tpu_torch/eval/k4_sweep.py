"""K4's ring route (`csrc/ivf_scan.cu`, `ivf_ring_kernel`) at each window
piece, beside the older kernel, to show why it takes the pieces it takes:

    python cuvs_rag_tpu_torch/eval/k4_sweep.py [--seed 0]

Variants: the older kernel (`ivf_scan_kernel`, 256-row chunks, the "cores"
route); the ring at window pieces of 256, 512, 1,024 rows and the whole
window (`ops/ivf_kernels._K4_PIECE` set), and as it ships ("ring_rule":
`k4_pieces` chooses from the call's pairs). Called through `ops/ivf_kernels.ivf_scan`
in two rounds over an IVF-Flat index of 6,290,000 x 384 bf16 clustered
rows (default params: 6,290 lists, window <= 2,048) at 20 probes, k = 10,
for 16 queries and one: the device ms of the scan and its merge a call
(`eval/roofline.device_ms`, torch.profiler over 50 calls; "device_ms") and
CUDA events around 20 calls ("ms": the wrapper's host time where that is
longer). Every variant is held against the plain version (rtol 1e-5 /
atol 1e-3, ids up to ties). Prints the card's name and power limit, then
one JSON line {"k4_sweep": {variant: {"16q_device_ms": [..], "16q_ms":
[..], "1q_device_ms": [..], "1q_ms": [..], "max_abs_err": ..}},
"live_rows": .., "bytes": .., "registers": ..}. It needs a CUDA device and
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

PIECES = {"256": 256, "512": 512, "1024": 1024, "whole": 0}
# K4's kernels as the profiler names them: either scan, and the merge
KERNELS = ("ivf_ring_kernel", "ivf_scan_kernel", "merge_partials_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms, device_ms, gpu_line
    from cuvs_rag_tpu_torch.index import ivf_flat
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import ivf_kernels as ik
    from cuvs_rag_tpu_torch.utils.compare import compare_topk
    from cuvs_rag_tpu_torch.utils.config import IVFFlatParams

    if not torch.cuda.is_available():
        print("k4_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    unit = torch.nn.functional.normalize
    centres = unit(torch.randn((4096, 384), generator=gen, device="cuda"), dim=1)
    rows = torch.randint(0, 4096, (6_290_000,), generator=gen, device="cuda")
    x = unit(centres[rows] + 0.05 * torch.randn((6_290_000, 384), generator=gen,
                                                device="cuda"), dim=1)
    ix = ivf_flat.build(IVFFlatParams(dtype="bfloat16"), x)
    queries = x[:16] + 0.02 * torch.randn((16, 384), generator=gen, device="cuda")
    del x, rows
    torch.cuda.empty_cache()

    def cores(dtype, d):
        return "cores"

    variants = {"cores_256": [mock.patch.object(ik, "ivf_route", cores)],
                "ring_rule": []}
    for name, piece in PIECES.items():
        variants[f"ring_{name}"] = [mock.patch.object(ik, "_K4_PIECE", piece)]
    out = {name: {f"{n}q_{t}": [] for n in (16, 1) for t in ("device_ms", "ms")}
           for name in variants}
    for row in out.values():
        row["max_abs_err"] = 0.0
    window = ix.max_list_size
    live = {}
    for n_q in (16, 1):
        q = queries[:n_q]
        probes, _ = ivf_flat.probe(ix, q, 20)
        p = probes.long()
        call = (ix.vectors, ix.sqnorms, ix.scales, q, ix.list_offsets[p],
                ix.list_counts[p])
        kw = dict(k=10, window=window, metric="sqeuclidean")
        live[n_q] = int(ix.list_counts[p].clamp(max=window).sum())
        want = ik.ivf_scan_plain(*call, **kw)
        for _ in range(2):
            for name, patches in variants.items():
                for patch in patches:
                    patch.start()
                try:
                    got = ik.ivf_scan(*call, **kw)
                    out[name]["max_abs_err"] = max(
                        out[name]["max_abs_err"],
                        compare_topk(*got, *want, rtol=1e-5, atol=1e-3))
                    out[name][f"{n_q}q_device_ms"].append(sum(device_ms(
                        lambda: ik.ivf_scan(*call, **kw), KERNELS).values()))
                    out[name][f"{n_q}q_ms"].append(
                        cuda_ms(lambda: ik.ivf_scan(*call, **kw), 20))
                finally:
                    for patch in patches:
                        patch.stop()
    registers = {n: r["registers"]
                 for n, r in build.resources("ivf_scan.cu").items()
                 if n.startswith("ivf_ring_kernel")}
    print(json.dumps({"k4_sweep": out, "window": window, "live_rows": live,
                      "bytes": {n: rows * (384 * 2 + 8) for n, rows in live.items()},
                      "registers": registers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
