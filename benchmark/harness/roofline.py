"""The least time a kernel call could take on one NVIDIA H100, and the
operations and bytes it needs.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W (dense
rates, no sparsity): 3.35 TB/s of HBM3, 989 TFLOP/s in bf16, 1,979 TOP/s
in int8, 67 TFLOP/s in fp32 outside the tensor cores (the port's
`chip_smoke.py` and `eval/roofline.py` use the same). A call's bound is
max(bytes / bandwidth, operations / peak of the arithmetic it runs), each
input byte counted once and each output byte once, whatever the kernel
reads again.
"""

from __future__ import annotations

from typing import Dict, Iterable

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S: Dict[str, float] = {
    "bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
}
ELEM_BYTES = {"bfloat16": 2, "int8": 1, "float32": 4}
# the arithmetic K1 runs for each storage dtype: bf16 and int8 rows on the
# tensor cores, fp32 rows in fp32 on the CUDA cores
K1_ARITH = {"bfloat16": "bf16", "int8": "int8", "float32": "fp32"}


def bound_s(n_bytes: float, n_ops: float, arith: str) -> float:
    """Seconds at the better of the two roofs it meets first."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[arith])


def k1_call(rows: int, dim: int, dtype: str, n_q: int, k: int) -> dict:
    """K1 (exact flat top-k) over `rows` stored rows for `n_q` fp32
    queries: the rows, their fp32 squared norms (and, for int8 rows, fp32
    scales) read once, the queries read once, (n_q, k) fp32 scores and
    int32 ids written once; 2 * n_q * rows * dim operations."""
    n_bytes = rows * dim * ELEM_BYTES[dtype] + rows * 4 \
        + (rows * 4 if dtype == "int8" else 0) \
        + n_q * dim * 4 + n_q * k * 8
    n_ops = 2.0 * n_q * rows * dim
    return {"bytes": n_bytes, "ops": n_ops,
            "bound_s": bound_s(n_bytes, n_ops, K1_ARITH[dtype])}


def k4_call(list_rows: Iterable[int], pair_rows: int, dim: int, dtype: str,
            n_q: int, n_probes: int, k: int) -> dict:
    """K4 (IVF-Flat probed-list scan) for one batch: `list_rows` the row
    count of each DISTINCT list the batch probes (each read once: rows,
    fp32 squared norms and fp32 scales), `pair_rows` the rows summed over
    every (query, probe) pair (each scored once: 2 * dim operations a
    row, in fp32 on the CUDA cores), the queries, the (n_q, n_probes)
    offsets, counts and coarse products read once, (n_q, k) scores and
    positions written once."""
    distinct = int(sum(list_rows))
    n_bytes = distinct * (dim * ELEM_BYTES[dtype] + 8) \
        + n_q * dim * 4 + n_q * n_probes * 12 + n_q * k * 8
    n_ops = 2.0 * pair_rows * dim
    return {"bytes": n_bytes, "ops": n_ops,
            "bound_s": bound_s(n_bytes, n_ops, "fp32")}
