"""Closed loop, one caller: back-to-back batches of query vectors through
the program's search, each batch's ids and distances copied to the host
before the next is sent, cycling a pool of distinct batches made at set-up.

Traffic parameters: batch (queries a call), pool_batches (distinct
batches). End-to-end metrics it measures: search_qps (queries whose ids
reached the host in the window / the window), and, where the
configuration names them, recall_at_10 (over every answer of the window,
against the reference's exact top-k) and build_s.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import cell as cell_lib
from benchmark.harness import compare, gen, systems, trace


def index_summary(program, batch: int) -> dict:
    """What the per-layer readers may need of the index, copied to the host
    before the program is freed: the queries one device's search call
    takes (a replicated index splits the batch, a sharded one hands each
    shard all of it); an IVF index's centroids, list sizes and probes a
    query; a flat index's rows (a shard's, a replica's), width and storage
    dtype."""
    ix = getattr(program, "index", None)
    if ix is None:
        return {}
    if hasattr(ix, "replicas"):
        per_call = -(-batch // len(ix.replicas))
        ix = ix.replicas[0]
    elif hasattr(ix, "local"):
        per_call, ix = batch, ix.local[0]
    else:
        per_call = batch
    out = {"dtype": str(ix.vectors.dtype).replace("torch.", ""),
           "dim": int(ix.vectors.shape[-1]), "queries_per_call": per_call}
    if hasattr(ix, "list_counts"):
        out.update(centroids=ix.centroids.float().cpu(),
                   list_counts=ix.list_counts.cpu().long(),
                   n_probes=int(program.search_params.n_probes))
    else:
        out.update(rows=int(ix.n_valid))
    return out


def probed_lists(summary: dict, pool) -> str:
    """The distinct lists each pool batch's queries probe, found as the
    index finds them (the n_probes nearest centroids), as min / mean / max
    over the pool."""
    cents = summary["centroids"].to(pool[0].device)
    cn = (cents * cents).sum(1)
    counts = []
    for q in pool:
        d = cn[None, :] - 2.0 * (q.float() @ cents.T)
        probes = torch.topk(d, summary["n_probes"], dim=1,
                            largest=False).indices
        counts.append(int(torch.unique(probes).numel()))
    return (f"min {min(counts)} mean {sum(counts) / len(counts)} max "
            f"{max(counts)} of {cents.shape[0]} lists, "
            f"{pool[0].shape[0] * summary['n_probes']} pairs a batch")


class GcPauses:
    """The process's garbage collections while it is registered:
    (generation, ns) each, a diagnostic of the rate's spread."""

    def __init__(self):
        self.items, self._t = [], None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter_ns()
        elif self._t is not None:
            self.items.append((info["generation"],
                               time.perf_counter_ns() - self._t))
            self._t = None

    def summary(self) -> str:
        ms = [ns / 1e6 for _, ns in self.items]
        gen2 = sum(1 for g, _ in self.items if g == 2)
        return (f"{len(ms)} collections ({gen2} of generation 2), longest "
                f"{max(ms, default=0.0)} ms, total {sum(ms)} ms")


def per_second(done_ns, t0_ns: int, batch: int) -> str:
    """Queries completed in each whole second of the window, as min /
    median / max and the slowest second's place."""
    n = int((max(done_ns) - t0_ns) // 1_000_000_000) if done_ns else 0
    if n < 1:
        return "window under a second"
    counts = np.bincount([(t - t0_ns) // 1_000_000_000 for t in done_ns],
                         minlength=n + 1)[:n] * batch
    return (f"min {counts.min()} median {np.median(counts)} max "
            f"{counts.max()} over {n} seconds, the slowest second "
            f"{int(counts.argmin())}")


def distinct_answers(answers, n_pool: int):
    """{pool batch: [(ids, dists, times returned)]} of the window's
    answers, each distinct answer once."""
    out = {b: [] for b in range(n_pool)}
    for b, ids, dists in answers:
        for entry in out[b]:
            if np.array_equal(entry[0], ids) and np.array_equal(entry[1],
                                                                dists):
                entry[2] += 1
                break
        else:
            out[b].append([ids, dists, 1])
    return out


def check(program_cfg, data, pool, answers, k):
    """Every distinct answer of the window against the reference ->
    (numbers, judged checks)."""
    n_pool, batch = len(pool), pool[0].shape[0]
    dist = distinct_answers(answers, n_pool)
    width = max(len(v) for v in dist.values()) or 1
    pairs = np.full((n_pool * batch, width * k), -1, np.int64)
    for b, entries in dist.items():
        for j, (ids, _, _) in enumerate(entries):
            pairs[b * batch:(b + 1) * batch, j * k:(j + 1) * k] = ids
    queries = torch.cat(pool)
    ref_d, ref_i, pair_d = systems.reference(
        program_cfg, data, queries, torch.from_numpy(pairs).to(
            queries.device))
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    pair_d = pair_d.cpu().numpy()
    worst = {"invalid": 0, "excess": 0.0, "dist_gap": 0.0}
    hits = total = 0
    missing = 0
    for b, entries in dist.items():
        rows = slice(b * batch, (b + 1) * batch)
        if not entries:
            missing += 1
        for j, (ids, dists, times) in enumerate(entries):
            nums = compare.numbers(dists, ids, ref_d[rows], ref_i[rows],
                                   pair_d[rows, j * k:(j + 1) * k],
                                   data.rows)
            worst["invalid"] += nums["invalid"] * times
            worst["excess"] = max(worst["excess"], nums["excess"])
            worst["dist_gap"] = max(worst["dist_gap"], nums["dist_gap"])
            hits += nums["recall_at_10"] * times
            total += times
    worst["recall_at_10"] = hits / total if total else float("nan")
    worst["distinct_answers"] = sum(len(v) for v in dist.values())
    worst["unanswered_batches"] = missing
    return worst, compare.judge(worst, program_cfg["guarantee"]["checks"])


def run(run: cell_lib.Run) -> cell_lib.Outcome:
    cell = run.cell
    cfg, traffic = cell.config, cell.traffic
    devices = run.devices
    batch, n_pool = int(traffic["batch"]), int(traffic["pool_batches"])
    k = int(cfg["guarantee"]["k"])

    data = gen.Data(cfg["data"], run.seed, devices[0])
    program = systems.make(cfg, data, devices, control=run.control)
    pool = list(data.queries(0, batch * n_pool).split(batch))
    search = program.search if run.fault is None else run.fault(
        program.search)
    summary = index_summary(program, batch)
    if "list_counts" in summary:
        run.log(f"distinct lists a batch probes: {probed_lists(summary, pool)}")
    if run.control:
        # the control answers each pool batch once, in one call
        d, i = search(torch.cat(pool))
        answers = [(b, i[b * batch:(b + 1) * batch].cpu().numpy(),
                    d[b * batch:(b + 1) * batch].cpu().numpy())
                   for b in range(n_pool)]
        setup_s = time.perf_counter() - run.t_start
        window_s, calls, spans_items = 1.0, [], []
        tracer = trace.DeviceTrace(False, devices)
        tracer.start()
        tracer.stop()
        counters = {}
    else:
        for b in range(min(3, n_pool)):  # warm-up: the one shape it uses
            d, i = search(pool[b])
            i.cpu(), d.cpu()
        systems.sync(devices)
        setup_s = time.perf_counter() - run.t_start
        from cuvs_rag_tpu_torch.utils.metrics import default_registry

        before = default_registry.snapshot()["counters"]
        spans = trace.Spans()
        tracer = trace.DeviceTrace(run.trace, devices)
        answers, calls, done_ns = [], [], []
        pauses = GcPauses()
        gc.callbacks.append(pauses)
        tracer.start()
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        n = 0
        while True:
            b = n % n_pool
            s0 = time.perf_counter_ns()
            d, i = search(pool[b])
            s1 = time.perf_counter_ns()
            ih, dh = i.cpu().numpy(), d.cpu().numpy()
            s2 = time.perf_counter_ns()
            spans.add("search call", s0, s1)
            spans.add("ids to host", s1, s2)
            answers.append((b, ih, dh))
            done_ns.append(s2)
            calls.append(b)
            n += 1
            # every pool batch is answered at least once
            if time.perf_counter() - t0 >= run.seconds and n >= n_pool:
                break
        window_s = time.perf_counter() - t0
        tracer.stop()
        gc.callbacks.remove(pauses)
        run.log(f"queries a second: {per_second(done_ns, t0_ns, batch)}")
        run.log(f"garbage collection in the window: {pauses.summary()}")
        after = default_registry.snapshot()["counters"]
        counters = {key: after[key] - before.get(key, 0) for key in after}
        spans_items = spans.items
    peak = cell_lib.memory_peak(devices)
    build_s = program.build_s
    program.free()
    del program, search
    for dv in devices:
        if dv.type == "cuda":
            with torch.cuda.device(dv):
                torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers, checks = check(cfg, data, pool, answers, k)
    run.log(f"set-up {setup_s:.2f} s (build {build_s:.2f} s), window "
            f"{window_s:.2f} s, reference {time.perf_counter() - t_ref:.2f} s")
    run.log(f"answers: {numbers['distinct_answers']} distinct over "
            f"{len(answers)} batches of {n_pool} in the pool; "
            f"{numbers['unanswered_batches']} pool batches unanswered")
    for name in ("recall_at_10", "excess", "dist_gap", "invalid"):
        run.log(f"reading {name} {numbers[name]}")
    record = {
        "events": tracer.events, "window": tracer.window,
        "cards": sorted({d.index for d in devices if d.type == "cuda"}),
        "spans": spans_items, "counters": counters,
        "info": {"calls": calls, "batch": batch, "k": k,
                 "pool": torch.cat(pool).cpu() if run.trace else None,
                 "index": summary}}
    metrics = {"search_qps": len(answers) * batch / window_s,
               "recall_at_10": numbers["recall_at_10"], "build_s": build_s}
    return cell_lib.Outcome(
        setup_s=setup_s, metrics=metrics, attempted=len(answers) * batch,
        failed=0, checks=checks, memory_peak_bytes=peak, record=record,
        numbers=numbers)
