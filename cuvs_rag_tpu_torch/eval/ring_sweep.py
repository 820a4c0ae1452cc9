"""K1's copy ring (`csrc/flat_topk.cu`, `exact_scan_kernel`) swept over its
sizes, to show why it has the ones it has:

    python cuvs_rag_tpu_torch/eval/ring_sweep.py [--seed 0]

Each variant is the source with its constants replaced: the stages of the
ring, a stage's bytes a row and the blocks an SM (the kernel's launch
bounds and the wrapper's split plan). Three more variants of the shipped
sizes leave work out, to show what overlaps with the copies: no products,
no selection, neither (their results are wrong and are not checked). The
variants are written to `build/ring_sweep/`, built by nvcc all at once,
and timed through `ops/flat_kernels.flat_topk_exact` in two rounds over
6,290,000 x 384 bf16 rows at 16 queries and one, k = 10 (CUDA events);
every variant that does all the work must return the scores and ids of
the source as it is (the sizes change no sum's order). Prints the card's
name and power limit, then one JSON line {"ring_sweep": {variant:
{"16q_ms": [..], "1q_ms": [..], "same_as_source": .., "registers": ..}}}.
It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (stages, bytes a row of a stage, blocks an SM); the first is the source's
SIZES = [(3, 128, 2), (3, 64, 2), (3, 96, 2), (3, 160, 2), (3, 192, 2),
         (4, 128, 2), (2, 128, 2), (2, 256, 2), (3, 384, 1), (4, 384, 1)]
STAGES = "constexpr int RING_STAGES = {};"
CHUNK = "constexpr int RING_CHUNK = {};"
BOUNDS = "__launch_bounds__(THREADS, {}) exact_scan_kernel"
PRODUCTS = ("const int units = width >> 5;", "const int units = 0;")
OFFER = "top[i].offer(r < n_live ? v : neg_inf(), (int)(row0 + r), k, lane);"
# a condition no score meets, which the compiler cannot know
SELECTION = (OFFER, "if (v == 1.2345e38f) " + OFFER)
LEFT_OUT = {"no_products": [PRODUCTS], "no_selection": [SELECTION],
            "copies_only": [PRODUCTS, SELECTION]}


def variants(source: str) -> dict:
    """{name: (source text, blocks an SM, does all the work)}."""
    base = SIZES[0]
    plans = {}
    for stages, chunk, blocks in SIZES:
        subs = [(STAGES.format(base[0]), STAGES.format(stages)),
                (CHUNK.format(base[1]), CHUNK.format(chunk)),
                (BOUNDS.format(base[2]), BOUNDS.format(blocks))]
        plans[f"stages{stages}_chunk{chunk}_blocks{blocks}"] = (subs, blocks, True)
    for name, subs in LEFT_OUT.items():
        plans[name] = (subs, base[2], False)
    out = {}
    for name, (subs, blocks, whole) in plans.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        out[name] = (text, blocks, whole)
    return out


def build_variants(source: str, folder: str, texts: dict) -> dict:
    """Write each variant {name: text} of csrc/`source` to build/`folder`/,
    beside copies of the shared headers, build them all at once with the
    source's signatures and return {name: path}; `build.load(path)` then
    gives a variant's library, as `build.load(source)` gives the source's."""
    from cuvs_rag_tpu_torch.kernels import build

    work = os.path.join(ROOT, "build", folder)
    os.makedirs(work, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, work)
    paths = {}
    for name, text in texts.items():
        paths[name] = os.path.join(work, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
        # an absolute path takes the place of a name under csrc/
        build.SIGNATURES[paths[name]] = build.SIGNATURES[source]
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(build.load, paths.values()))
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from cuvs_rag_tpu_torch.eval.roofline import cuda_ms, gpu_line
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import flat_kernels as fk
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    if not torch.cuda.is_available():
        print("ring_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)

    made = variants((build.CSRC / "flat_topk.cu").read_text())
    paths = build_variants("flat_topk.cu", "ring_sweep",
                           {name: text for name, (text, _, _) in made.items()})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.nn.functional.normalize(
        torch.randn((6_290_000, 384), generator=gen, device="cuda"), dim=1)
    ix = flat.build(FlatParams(dtype="bfloat16"), x)
    kw = dict(k=10, metric="sqeuclidean")
    out = {name: {"16q_ms": [], "1q_ms": [], "same_as_source": None,
                  "registers": build.resources(path)["exact_scan_kernel<0>"]
                  ["registers"]}
           for name, path in paths.items()}
    for n_q in (16, 1):
        call = (ix.vectors, ix.sqnorms, x[:n_q] + 0.01, ix.n_valid, ix.scales)
        want = fk.flat_topk_exact(*call, **kw)  # the source's own build
        for _ in range(2):
            for name, (_, blocks, whole) in made.items():
                with mock.patch.object(fk, "_SOURCE", paths[name]), \
                        mock.patch.object(fk, "_RING_BLOCKS_PER_SM", blocks):
                    if whole:
                        got = fk.flat_topk_exact(*call, **kw)
                        same = all(torch.equal(g, w) for g, w in zip(got, want))
                        out[name]["same_as_source"] = (
                            same and out[name]["same_as_source"] is not False)
                    out[name][f"{n_q}q_ms"].append(cuda_ms(
                        lambda: fk.flat_topk_exact(*call, **kw), 10))
    print(json.dumps({"ring_sweep": out}), flush=True)
    return int(any(v["same_as_source"] is False for v in out.values()))


if __name__ == "__main__":
    sys.exit(main())
