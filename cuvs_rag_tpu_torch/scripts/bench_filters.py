"""Filtered-search overhead (index/filters.py) at 2M x 768 bf16.

    python -m cuvs_rag_tpu_torch.scripts.bench_filters [--device cuda]

(a) filtered against unfiltered search latency for flat (K1) and IVF-Flat
(K4): a view rides the sqnorm slot's tombstone penalty, so the expected
marginal cost is ~zero; (b) the one-off cost of building a view (one
elementwise pass for flat, a gather over the layout for IVF), cold and
again with a new mask. A 50%-selectivity allow list; every result is held
inside it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from cuvs_rag_tpu_torch.scripts import common

N, D, K, BATCH, REPS = 2_000_000, 768, 10, 100, 10
N_LISTS = 2000


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(p)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--n-lists", type=int, default=N_LISTS)
    return p.parse_args(argv)


def _timed(fn, queries, reps):
    return common.time_batches(fn, [queries] * reps)


def _view(filters, index, allow, dev):
    t0 = time.perf_counter()
    view = filters.filtered_view(index, allow)
    common.sync(dev)
    return view, time.perf_counter() - t0


def _held(ids, allow):
    ids = ids.cpu().numpy()
    if not np.all((ids == -1) | allow[np.maximum(ids, 0)]):
        raise AssertionError("a filtered result leaves the allow list")


def run(args, hold=None) -> dict:
    from cuvs_rag_tpu_torch.index import filters, flat, ivf_flat
    from cuvs_rag_tpu_torch.utils.config import (
        FlatParams, IVFFlatParams, IVFFlatSearchParams)

    dev = common.device_of(args)
    print(common.device_label(dev), flush=True)
    corpus, queries, _ = common.clustered_setup(args.n, args.dim, args.n_lists,
                                                BATCH, 0, dev)
    allow = np.random.default_rng(7).random(args.n) < 0.5  # 50% selectivity
    out = {}

    fx = flat.build(FlatParams(dtype="bfloat16", tile_n=8192), corpus)
    t_plain = _timed(lambda q: flat.search(None, fx, q, K), queries, REPS)
    if hold:
        hold("flat", corpus, queries, *flat.search(None, fx, queries, K))
    view, t_view = _view(filters, fx, allow, dev)
    _held(flat.search(None, view, queries, K)[1], allow)
    t_filt = _timed(lambda q: flat.search(None, view, q, K), queries, REPS)
    print(f"flat   search {t_plain/BATCH*1e3:.4f} ms/q -> filtered "
          f"{t_filt/BATCH*1e3:.4f} ms/q  (view build {t_view*1e3:.1f} ms, "
          "incl. the host mask's transfer)", flush=True)
    out["flat"] = {"ms": t_plain * 1e3, "filtered_ms": t_filt * 1e3,
                   "view_ms": t_view * 1e3}
    del fx, view

    ix = ivf_flat.build(IVFFlatParams(n_lists=args.n_lists, dtype="bfloat16",
                                      kmeans_sample=100_000), corpus)
    sp = IVFFlatSearchParams(n_probes=10)
    t_plain = _timed(lambda q: ivf_flat.search(sp, ix, q, K), queries, REPS)
    view, t_view = _view(filters, ix, allow, dev)
    _held(ivf_flat.search(sp, view, queries, K)[1], allow)
    t_filt = _timed(lambda q: ivf_flat.search(sp, view, q, K), queries, REPS)
    _, t_view_warm = _view(filters, ix, ~allow, dev)  # a new mask
    print(f"ivf    search {t_plain/BATCH*1e3:.4f} ms/q -> filtered "
          f"{t_filt/BATCH*1e3:.4f} ms/q  (view build cold {t_view*1e3:.1f} "
          f"ms / warm {t_view_warm*1e3:.1f} ms)", flush=True)
    out["ivf"] = {"ms": t_plain * 1e3, "filtered_ms": t_filt * 1e3,
                  "view_ms": t_view * 1e3, "view_warm_ms": t_view_warm * 1e3}
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
