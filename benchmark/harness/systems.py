"""The system under test, as a configuration's "index" and "placement"
blocks name it: an index of the port's families, built through the port's
own entry points on the run's devices, and searched through
`parallel/search.search`, the entry every placement shares. Also the
control a configuration names: the port with another storage precision
("program"), or the plain reference at a lower precision in the program's
place ("reference").
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from benchmark.reference import exact_topk as ref


def _params(block: Optional[dict]):
    """A dataclass of the port's `utils/config` from {"class": name, ...}."""
    if block is None:
        return None
    from cuvs_rag_tpu_torch.utils import config as pcfg

    kw = {k: v for k, v in block.items() if k != "class"}
    return getattr(pcfg, block["class"])(**kw)


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Program:
    """The port's index over the corpus, and its search.

    `search(queries)` -> ((Q, k) distances, (Q, k) ids) on the first
    device, through parallel/search.search. `build_s` is the build's host
    seconds, from rows on the device to an index searched by nothing yet,
    synchronised."""

    def __init__(self, cfg: dict, data, devices: List[torch.device],
                 params_override: Optional[dict] = None):
        from cuvs_rag_tpu_torch.parallel import search as psearch
        from cuvs_rag_tpu_torch.parallel.mesh import DeviceMesh

        ix = cfg["index"]
        self.family = ix["family"]
        self.k = int(cfg["guarantee"]["k"])
        pblock = dict(ix["params"], **(params_override or {}))
        self.params = _params(pblock)
        self.search_params = _params(ix.get("search_params"))
        placement = cfg["placement"]["kind"]
        self.devices = devices
        self.dmesh = DeviceMesh(devices) if placement != "single" else None
        self._psearch = psearch
        mod = psearch.FAMILIES[self.family]
        rows = data.corpus()
        sync(devices)
        t0 = time.perf_counter()
        if placement == "single":
            if ix.get("build") == "chunks":
                step = data.chunk_rows
                self.index = mod.build_from_chunks(
                    self.params, lambda i: rows[i * step:(i + 1) * step],
                    data.rows, data.dim, n_chunks=data.n_chunks,
                    device=devices[0])
            else:
                self.index = mod.build(self.params, rows, device=devices[0])
        elif placement == "replicate":
            self.index = psearch.build_replicated(self.family, self.params,
                                                  rows, self.dmesh)
        elif placement == "shard":
            self.index = psearch.build_sharded(self.family, self.params,
                                               rows, self.dmesh)
        else:
            raise ValueError(f"unknown placement {placement!r}")
        sync(devices)
        self.build_s = time.perf_counter() - t0
        del rows

    def search(self, queries: torch.Tensor):
        return self._psearch.search(self.search_params, self.index, queries,
                                    self.k, self.dmesh)

    def free(self) -> None:
        self.index = None
        self.dmesh = None


class ReferenceInPlace:
    """The control "reference": the plain exact search at a lower
    precision in the program's place, over the chunks made again."""

    def __init__(self, cfg: dict, data, devices: List[torch.device],
                 precision: str):
        self.k = int(cfg["guarantee"]["k"])
        self.data = data
        self.precision = precision
        self.build_s = 0.0

    def search(self, queries: torch.Tensor):
        d, i, _ = ref.exact_topk(self.data.chunk, self.data.n_chunks,
                                 self.data.chunk_rows, queries, self.k,
                                 precision=self.precision)
        return d.float(), i.int()

    def free(self) -> None:
        pass


def make(cfg: dict, data, devices: List[torch.device],
         control: bool = False):
    """The program, or with `control` the configuration's control."""
    if not control:
        return Program(cfg, data, devices)
    c = cfg["control"]
    if c["kind"] == "program":
        return Program(cfg, data, devices, params_override=c["params"])
    if c["kind"] == "reference":
        return ReferenceInPlace(cfg, data, devices, c["precision"])
    raise ValueError(f"unknown control {c['kind']!r}")


def reference(cfg: dict, data, queries: torch.Tensor,
              pairs: torch.Tensor):
    """The plain reference over the configuration's corpus, made again
    from the seed: (exact distances, exact ids, distances of `pairs`), on
    the queries' device, in float64."""
    return ref.exact_topk(data.chunk, data.n_chunks, data.chunk_rows,
                          queries, int(cfg["guarantee"]["k"]), pairs=pairs)

