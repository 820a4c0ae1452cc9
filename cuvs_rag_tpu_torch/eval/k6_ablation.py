"""Where K6's time on the device goes (`csrc/pq_adc.cu`, `pq_adc_kernel`):

    python cuvs_rag_tpu_torch/eval/k6_ablation.py [--seed 0]

Variants of the source leave one part of the kernel's work out: the table
lookups (the nibbles are added instead), the code loads (a word is made up
from the slot and the stream), the table's bulk copy, the ids and
corrections, both the code loads and the lookups; two more keep only the
code loads and only the lookups. Results of these are wrong and are not
checked. Others change the design and give the same results: the code
words loaded through the caches (`__ldg`) in place of streaming loads
(`__ldcs`), the stream loop unrolled 4 or 8 times in place of 16, and the
design of code tiles in shared memory ("tile_by_tma": each chunk's codes
copied by TMA bulk copies, one a stream row, read there 32 bits at a
time). Beside them the shipped source and "tile_by_tma" run with chunks
of 256 and 128 slots a block (`ops/pq_kernels._MAX_CHUNK` lowered: the
tile shrinks with the chunk, so more blocks fit an SM at 96 code bytes).
These and the shipped source are held to the plain version. Each is launched
through `ops/pq_kernels.pq_adc_scores` and its kernel's device
microseconds a launch are read from torch.profiler over 50 launches,
twice, at 16 queries x 20
probes, windows of 1,280 slots, 48 code bytes a row: with 400 to 1,280
live rows in a 7.9M-slot layout (the main path's shape), the same with a
262,144-slot layout whose codes stay in L2, with every window full, with
64 queries, and with 96 code bytes a row (the CLI's pq_dim), there also at
100 queries. Prints the card's name and power limit, then one JSON line
{"k6_ablation": {shape: {variant: [us, us]}}}. It needs a CUDA device and
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

# the nibble's bits added as a float (no conversion instruction)
LOOKUPS = ("    lo[u] += l0[(b >> (8 * u)) & 15u];\n"
           "    hi[u] += l1[(b >> (8 * u + 4)) & 15u];",
           "    lo[u] += __uint_as_float((b >> (8 * u)) & 15u);\n"
           "    hi[u] += __uint_as_float((b >> (8 * u + 4)) & 15u);")
LOAD = "        lookup4(__ldcs(w), l0, l1, lo, hi);"
READS = (LOAD, "        lookup4((uint32_t)(s * 37) * 0x01010101u + t, l0, l1, lo, hi);")
CACHED = (LOAD, LOAD.replace("__ldcs", "__ldg"))
TABLE = ("    bulk_copy(smem_u32(lut), luts + qp * mb * 32, lut_bytes, bar_a);", "")
TABLE_TX = ("    mbar_arrive_expect_tx(bar_a, lut_bytes);",
            "    mbar_arrive_expect_tx(bar_a, 0u);")
IDS = ("""  if (j < lim) {
    const int* rid = &row_ids[slot];
    if (j + SLOTS <= lim && aligned16(rid)) {
      const int4 r = *reinterpret_cast<const int4*>(rid);
      id[0] = r.x; id[1] = r.y; id[2] = r.z; id[3] = r.w;
    } else {
#pragma unroll
      for (int u = 0; u < SLOTS; ++u) id[u] = j + u < lim ? rid[u] : -1;
    }
  }""", """#pragma unroll
  for (int u = 0; u < SLOTS; ++u) id[u] = j + u < lim ? j + u : -1;""")
CORR = ("  if (corr != nullptr && scored) {", "  if (false) {")


def _unroll(n):
    return ("#pragma unroll 16\n      for (int s = 0; s < mb; ++s) {\n"
            "        lookup4(__ldcs",
            f"#pragma unroll {n}\n      for (int s = 0; s < mb; ++s) {{\n"
            "        lookup4(__ldcs")


# The design of code tiles in shared memory: the chunk's (mb, chunk) codes
# copied by the copy engine, one TMA bulk copy a stream row up to the live
# count (rounded up to 16 bytes, cut at cap) on the table's mbarrier, then
# read 32 bits at a time from shared memory. The shapes timed here have
# tiles at 16-byte aligned starts of a cap that is a multiple of 16, which
# such copies need.
TILE_SMEM = ("  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + mb * 128);",
             """  unsigned char* tile = smem + mb * 128;  // (mb, chunk + 16)
  const int tpitch = blockDim.x * SLOTS + 16;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + mb * tpitch);""")
TILE_COPY = ("""    mbar_arrive_expect_tx(bar_a, lut_bytes);
    bulk_copy(smem_u32(lut), luts + qp * mb * 32, lut_bytes, bar_a);""",
             """    const int row_bytes =
        (int)min((long long)((lim - j0 + 15) & ~15), cap - off - j0);
    mbar_arrive_expect_tx(bar_a, lut_bytes + (uint32_t)(mb * row_bytes));
    bulk_copy(smem_u32(lut), luts + qp * mb * 32, lut_bytes, bar_a);
    for (int s = 0; s < mb; ++s)
      bulk_copy(smem_u32(tile + s * tpitch), src + s * cap, row_bytes, bar_a);""")
TILE_READ = (LOAD, "        lookup4(reinterpret_cast<const uint32_t*>(tile)"
             "[s * (tpitch >> 2) + t], l0, l1, lo, hi);")
TILE_ENTRY = ("  const long long smem = (long long)mb * 128 + 16;",
              "  const long long smem = (long long)mb * 128 + 16\n"
              "                         + (long long)mb * (chunk + 16);")
LEFT_OUT = {
    "shipped": [], "no_lookups": [LOOKUPS], "no_code_reads": [READS],
    "no_table_copy": [TABLE, TABLE_TX, LOOKUPS],
    "no_ids_corr": [IDS, CORR],
    "no_code_work": [READS, LOOKUPS],
    "only_code_reads": [LOOKUPS, TABLE, TABLE_TX, IDS, CORR],
    "only_lookups": [READS, IDS, CORR],
    "cached_loads": [CACHED], "unroll_4": [_unroll(4)],
    "unroll_8": [_unroll(8)],
    "tile_by_tma": [TILE_SMEM, TILE_COPY, TILE_READ, TILE_ENTRY],
}
# the variants that change the design, not the work: held to the plain version
SAME_RESULTS = ("cached_loads", "unroll_4", "unroll_8", "tile_by_tma")
# the largest chunk lowered to these, for the shipped source and the tiles
CHUNKS = (256, 128)
CHUNKED = ("shipped", "tile_by_tma")
WINDOW = 1280
# name: (slots of the layout, queries, fewest live rows of a window, mb)
SHAPES = {"7.9M slots, 400-1280 live": (7_900_032, 16, 400, 48),
          "262,144 slots (codes in L2)": (262_144, 16, 400, 48),
          "7.9M slots, full windows": (7_900_032, 16, WINDOW, 48),
          "7.9M slots, 64 queries": (7_900_032, 64, 400, 48),
          "2.1M slots, 400-1280 live, mb 96": (2_100_096, 16, 400, 96),
          "2.1M slots, mb 96, 100 queries": (2_100_096, 100, 400, 96)}


def variants(source: str) -> dict:
    """{name: source text with that work left out}."""
    out = {}
    for name, subs in LEFT_OUT.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    from cuvs_rag_tpu_torch.eval.ring_sweep import build_variants
    from cuvs_rag_tpu_torch.eval.roofline import device_ms, gpu_line
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import pq_kernels as pk

    if not torch.cuda.is_available():
        print("k6_ablation: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), flush=True)
    paths = build_variants("pq_adc.cu", "k6_ablation",
                           variants((build.CSRC / "pq_adc.cu").read_text()))

    kw = dict(generator=torch.Generator(device="cuda").manual_seed(args.seed),
              device="cuda")
    out = {}
    for shape, (cap, n_q, fewest, mb) in SHAPES.items():
        pairs = (n_q, 20)
        call = (torch.randint(0, 256, (mb, cap), dtype=torch.uint8, **kw),
                torch.randint(0, 1 << 22, (cap,), dtype=torch.int32, **kw),
                torch.randn(cap, **kw), torch.randn(pairs + (2 * mb, 16), **kw),
                (torch.randint(0, (cap - WINDOW) // 128, pairs, **kw) * 128).int(),
                torch.randint(fewest, WINDOW + 1, pairs, **kw).int(),
                torch.randn(pairs, **kw))
        runs = [(name, path, pk._MAX_CHUNK) for name, path in paths.items()]
        runs += [(f"{name}_chunk{c}", paths[name], c)
                 for name in CHUNKED for c in CHUNKS]
        out[shape] = {}
        for name, path, chunk in runs:
            with mock.patch.object(pk, "_SOURCE", path), \
                    mock.patch.object(pk, "_MAX_CHUNK", chunk):
                s, i = pk.pq_adc_scores(*call, window=WINDOW)
                if name.split("_chunk")[0] in SAME_RESULTS + ("shipped",):
                    # a design variant: held to the plain version
                    ps, pi = pk.pq_adc_scores_plain(*call, window=WINDOW)
                    live = torch.isfinite(ps)
                    if not torch.equal(i, pi) or not torch.allclose(
                            s[live], ps[live], rtol=1e-5, atol=1e-4):
                        raise AssertionError(f"{name} differs from plain")
                torch.cuda.synchronize()
                out[shape][name] = [1e3 * device_ms(
                    lambda: pk.pq_adc_scores(*call, window=WINDOW),
                    ("pq_adc_kernel",), 50)["pq_adc_kernel"] for _ in range(2)]
        del call
    print(json.dumps({"k6_ablation": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
