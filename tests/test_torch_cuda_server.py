"""The serving layer on the card: the kernels' launches from many host
threads at once, and a small daemon over a flat index on the card. CUDA
kernels have no CPU mode, so without a GPU these skip.

Run on a GPU machine (tests/conftest.py imports jax, which the port's
machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda_server.py

Tolerances: a launch from a thread must give bit for bit what the same
call gives alone (the kernels are deterministic; a launch refused for its
shared memory raises), so results are held with torch.equal.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_threads_launch_with_their_own_shared_memory(cuda_device):
    """8 threads each run K1 (k = 10) and K3 (k = 50, 500, 2,000) at 1, 16
    and 40 queries on one 300,000 x 384 bf16 index, and K7 at head widths
    64 and 128 (bf16) and 64 (fp32), 50 times each in their own orders:
    every call's kernels take their own dynamic shared memory, which the
    launch code raises from whichever thread comes first. Each result
    equals the single-threaded run of the same call, and no launch fails."""
    from cuvs_rag_tpu_torch.index import flat
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.ops import attention_kernels as ak
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.nn.functional.normalize(
        torch.randn(300_000, 384, generator=g, device=cuda_device), dim=1)
    index = flat.build(FlatParams(dtype="bfloat16"), x)
    queries = {n: torch.nn.functional.normalize(
        x[:n] + 0.05 * torch.randn(n, 384, generator=g, device=cuda_device),
        dim=1) for n in (1, 16, 40)}
    calls = [("flat", n, k) for n in (1, 16, 40) for k in (10, 50, 500, 2000)]
    attn = {}
    for hd, dtype in ((64, torch.bfloat16), (128, torch.bfloat16),
                      (64, torch.float32)):
        q, k, v = (torch.randn(2, 256, 4, hd, generator=g, device=cuda_device)
                   .to(dtype) for _ in range(3))
        mask = torch.ones(2, 256, dtype=torch.int32, device=cuda_device)
        attn[(hd, dtype)] = (q, k, v, mask)
        calls.append(("attn", hd, dtype))

    def run(call):
        if call[0] == "flat":
            _, n, k = call
            return flat.search(None, index, queries[n], k)
        return (ak.flash_attention(*attn[call[1:]], sm_scale=0.125),)

    entries = ("flat_exact_topk", "flat_exact_wide_topk", "flat_topr",
               "flash_attention")
    before = {e: build.launches[e] for e in entries}
    want = {c: run(c) for c in calls}
    torch.cuda.synchronize()
    errors, bad = [], []

    def worker(t):
        order = np.random.default_rng(t).permutation(len(calls) * 50)
        try:
            for j in order:
                c = calls[j % len(calls)]
                got = run(c)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want[c])):
                    bad.append(c)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert not bad, sorted(set(bad), key=str)[:5]
    # every call took its kernel: K1 at k = 10, K3 above 32, K7
    ran = {e: build.launches[e] - before[e] for e in entries}
    assert ran["flat_exact_topk"] + ran["flat_exact_wide_topk"] >= 3 * 401
    assert ran["flat_topr"] >= 9 * 401
    assert ran["flash_attention"] > 0


def test_daemon_on_the_card(cuda_device):
    """The daemon over a 300,000-row bf16 flat index on the card, with the
    smoke's own checks (chip_smoke.daemon_checks): planted passages at
    top-1 from 16 concurrent clients (mean micro-batch above 1), raw
    vectors, a deny list past k = 32 (K3), views, live extend and delete
    beside searches, /healthz and /stats naming the card; K1 and K3 ran."""
    import chip_smoke
    from cuvs_rag_tpu_torch.kernels import build
    from cuvs_rag_tpu_torch.models.encoder import HashingEncoder
    from cuvs_rag_tpu_torch.rag.corpus import Corpus
    from cuvs_rag_tpu_torch.rag.pipeline import Retriever
    from cuvs_rag_tpu_torch.utils.config import FlatParams

    n, d = 300_000, 384
    rng = np.random.default_rng(0)
    enc = HashingEncoder(dim=d)
    texts = chip_smoke.synthetic_passages(256, rng)
    planted = np.sort(rng.choice(n, 256, replace=False))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.nn.functional.normalize(
        torch.randn(n, d, generator=g, device=cuda_device), dim=1)
    x[torch.as_tensor(planted, device=cuda_device)] = torch.as_tensor(
        enc.encode(texts), device=cuda_device)
    passages = [""] * n
    for row, t in zip(planted.tolist(), texts):
        passages[row] = t
    retriever = Retriever.build(
        Corpus(passages=passages, embeddings=x), enc, family="flat",
        params=FlatParams(dtype="bfloat16"))
    assert retriever.index.device.type == "cuda"
    before = dict(build.launches)
    out = chip_smoke.daemon_checks(retriever, enc, planted, texts,
                                   range(16, 16 + 128), view_rows=50_000)
    assert out["device"][1] == torch.cuda.get_device_name(cuda_device)
    assert out["mean_microbatch"] > 1.0
    ran = {e: n - before[e] for e, n in build.launches.items()}
    assert ran["flat_exact_topk"] + ran["flat_exact_wide_topk"] > 0
    assert ran["flat_topr"] > 0
