"""The card's measured memory ceilings: streaming reads and scattered gathers.

    python -m cuvs_rag_tpu_torch.eval.roofline [--n 2000000 --dim 768 --m 131072]

The counterpart of the `main()`s of the JAX package's scripts/
bench_roofline.py, bench_gather_modes.py and bench_pallas_gather.py. It
prints the card's name and power limit, then one JSON object with

- the streaming-read rate of an (n, dim) bf16 corpus through M1 `read_all`
  in both modes ("touch" and "reduce") beside `torch.amax` over the same
  tensor: the measured floor of every kernel that scans a corpus once;
- the scattered-gather rates of m rows into that corpus through M2 / M4
  `gather_rows` (rows of bf16 and of int8, 50% and 90% duplicate ids, 32-row
  spans) and M3 `gather_reduce` (gather and sum on chip, no write-back)
  beside `torch.index_select` (and, for float rows, `embedding_bag` with
  one bag, the nearest library call to a gather that sums): the ceiling of
  a refine gather or a graph search's beam.

Times are CUDA events over back-to-back calls. Rates are payload bytes (the
corpus once; the gathered rows once) over time, in GB/s. It needs a CUDA
device and fails without one. Every case is first held against its plain
version (`check_read`, `check_gathers`, which own those comparisons and
their tolerance). `chip_smoke.py` calls the same functions on its own corpus.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from cuvs_rag_tpu_torch.ops import stream_kernels as sk

SPAN = 32  # rows of a contiguous span (bench_gather_modes.py's blocks)
# Untimed calls before a read rate is taken: after three, "reduce" over a
# 4.83 GB corpus still read 2.64 to 3.04 TB/s from run to run on an H100
# (700 W) while the two calls beside it stood still
_READ_WARMUP = 10
# gather_reduce vs its plain version: fp32 sums of 131,072 rows of
# unit-variance values in another order
REDUCE_TOL = dict(rtol=1e-4, atol=2e-3)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, names, calls: int = 50, warmup: int = 3,
              attempts: int = 3) -> dict:
    """Device ms a call of the kernels whose names contain each of `names`
    ({name: ms}), over `calls` back-to-back fn() under torch.profiler: the
    kernels' own time, apart from the host's time to launch them (which
    CUDA events around a loop of calls measure where it is the longer).
    `names` may list alternatives of which a call runs only some; a name
    that no window records reads 0. The profiler on the card has been seen
    to drop kernel records: the first call's of a window (K4 read as 49
    launches of 50 in each of three windows), and more (20 launches read
    as 5, or as none). So each window is profiled after a step of `calls`
    calls that the profiler's schedule records and discards, and a window
    is taken again, up to `attempts` windows, where it records no named
    kernel or fewer than `calls` launches of a name recorded in any window
    so far; past that this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ran = set()  # names some window recorded: a call runs them
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):  # the discarded step, then the window
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total = dict.fromkeys(names, 0.0)
        count = dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for name in names:
                    if name in e.key:
                        total[name] += e.self_device_time_total / 1e3
                        count[name] += e.count
        ran.update(name for name in names if count[name])
        if ran and all(count[name] >= calls for name in ran):
            return {name: total[name] / calls for name in names}
    raise RuntimeError(f"torch.profiler recorded {count} launches of "
                       f"{sorted(ran) or list(names)} over {calls} calls in "
                       f"each of {attempts} windows")


def host_us(fn, iters: int = 300, warmup: int = 30) -> float:
    """Mean host time of one fn() call in microseconds: what the caller's
    thread spends before the call returns, the launch still in flight (the
    card is only waited for before and after the loop). Where this exceeds
    the kernel's time, it is what a loop of such calls costs. Few enough
    calls that the launch queue never fills and blocks the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / iters * 1e6


def _rate(n_bytes: int, ms: float, rows: int = 0) -> dict:
    out = {"ms": ms, "gb_per_s": n_bytes / ms / 1e6}
    if rows:
        out["ns_per_row"] = ms * 1e6 / rows
    return out


def check_read(corpus: torch.Tensor) -> int:
    """M1 in both modes against its plain version, equal bit for bit (a
    maximum has no order). Returns the number of cases held."""
    for full in (False, True):
        if not torch.equal(sk.read_all(corpus, full),
                           sk.read_all_plain(corpus, full)):
            raise AssertionError(f"read_all(full_reduce={full}) on "
                                 f"{corpus.shape[0]} rows differs from plain")
    return 2


def check_gathers(vectors: torch.Tensor, sets: dict) -> dict:
    """M2 - M4 against their plain versions on the id sets of `gather_ids`:
    `gather_rows` on every set equal bit for bit (a copy), `gather_reduce`
    on the uniform and the 50%-duplicate ids within REDUCE_TOL. Returns the
    number of cases held and gather_reduce's largest absolute error on each
    of its two id sets (the duplicates' sums are some hundred times larger)."""
    out = {"cases": 0, "reduce_max_abs_err": {}}
    for name, ids in sets.items():
        span = SPAN if name.startswith("span") else 1
        if not torch.equal(sk.gather_rows(vectors, ids, span),
                           sk.gather_rows_plain(vectors, ids, span)):
            raise AssertionError(f"gather_rows ({name}, {vectors.dtype}) "
                                 f"differs from plain")
        out["cases"] += 1
    for name in ("rows", "dup50"):
        got = sk.gather_reduce(vectors, sets[name])
        want = sk.gather_reduce_plain(vectors, sets[name])
        torch.testing.assert_close(got, want, **REDUCE_TOL)
        out["reduce_max_abs_err"][name] = float((got - want).abs().max())
        out["cases"] += 1
    return out


def read_rates(corpus: torch.Tensor, iters: int = 20) -> dict:
    """Streaming-read rates of an (n, d) bf16 corpus: M1 in both modes and
    `torch.amax`. Timing only: `check_read` holds the same calls against
    the plain version."""
    n_bytes = corpus.numel() * corpus.element_size()
    out = {"rows": corpus.shape[0], "dim": corpus.shape[1], "bytes": n_bytes}
    for mode, full in (("touch", False), ("reduce", True)):
        out[mode] = _rate(n_bytes, cuda_ms(
            lambda: sk.read_all(corpus, full), iters, _READ_WARMUP))
    out["torch_amax"] = _rate(n_bytes, cuda_ms(
        lambda: torch.amax(corpus), iters, _READ_WARMUP))
    out["best_gb_per_s"] = max(out["touch"]["gb_per_s"],
                               out["reduce"]["gb_per_s"])
    return out


def gather_ids(n: int, m: int, gen: torch.Generator) -> dict:
    """The id sets of the gather cases: m uniform row ids; the same with the
    first 50% / 90% set to row 0; m / SPAN uniform span starts."""
    dev = gen.device
    ids = torch.randint(0, n, (m,), generator=gen, device=dev)
    out = {"rows": ids}
    for pct in (50, 90):
        dup = ids.clone()
        dup[: m * pct // 100] = 0
        out[f"dup{pct}"] = dup
    out[f"span{SPAN}"] = torch.randint(0, n - SPAN + 1, (max(1, m // SPAN),),
                                       generator=gen, device=dev)
    return out


def gather_rates(vectors: torch.Tensor, sets: dict, iters: int = 10) -> dict:
    """Scattered-gather rates of rows of `vectors` (n, d) on the id sets of
    `gather_ids`: `gather_rows` on each set, `gather_reduce`, and
    `torch.index_select` as the library's gather, and the host microseconds
    a call of each takes (`host_us`). Timing only, ids unchecked:
    `check_gathers` holds the same calls against the plain versions, and
    checks the ids."""
    n, d = vectors.shape
    row_bytes = d * vectors.element_size()
    m = sets["rows"].numel()
    out = {"rows_in_corpus": n, "row_bytes": row_bytes, "m": m,
           "dtype": str(vectors.dtype).replace("torch.", "")}
    for name, ids in sets.items():
        span = SPAN if name.startswith("span") else 1
        rows = ids.numel() * span
        out[name] = _rate(rows * row_bytes, cuda_ms(
            lambda: sk.gather_rows(vectors, ids, span, check_ids=False),
            iters), rows)
    ids = sets["rows"]
    out["reduce"] = _rate(m * row_bytes, cuda_ms(
        lambda: sk.gather_reduce(vectors, ids, check_ids=False), iters), m)
    out["torch_index_select"] = _rate(m * row_bytes, cuda_ms(
        lambda: vectors.index_select(0, ids), iters), m)
    # the wrappers' host work beside the library call's
    out["host_us"] = {
        "gather_rows": host_us(
            lambda: sk.gather_rows(vectors, ids, check_ids=False)),
        "gather_reduce": host_us(
            lambda: sk.gather_reduce(vectors, ids, check_ids=False)),
        "torch_index_select": host_us(lambda: vectors.index_select(0, ids)),
    }
    if vectors.is_floating_point():
        # the nearest single library call to gather_reduce, not the same
        # function: its sum comes back rounded to the rows' own dtype
        one_bag = torch.zeros(1, dtype=torch.int64, device=ids.device)
        out["torch_embedding_bag_sum"] = _rate(m * row_bytes, cuda_ms(
            lambda: torch.nn.functional.embedding_bag(
                ids, vectors, one_bag, mode="sum"), iters), m)
    return out


def make_corpus(n: int, dim: int, gen: torch.Generator) -> torch.Tensor:
    """(n, dim) bf16 standard-normal rows, made on the device in chunks."""
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=gen.device)
    for i in range(0, n, 1 << 18):
        rows = min(1 << 18, n - i)
        out[i:i + rows] = torch.randn((rows, dim), generator=gen,
                                      device=gen.device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--m", type=int, default=131_072)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline: CUDA is not available", file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(gpu, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    corpus = make_corpus(args.n, args.dim, gen)
    int8 = (corpus.float() * 40).clamp(-127, 127).to(torch.int8)
    sets = gather_ids(args.n, args.m, gen)
    print(json.dumps({
        "gpu": gpu, "device": torch.cuda.get_device_name(0),
        "cases_held": check_read(corpus) + sum(
            check_gathers(x, sets)["cases"] for x in (corpus, int8)),
        "read": read_rates(corpus),
        "gather_bf16": gather_rates(corpus, sets),
        "gather_int8": gather_rates(int8, sets),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
