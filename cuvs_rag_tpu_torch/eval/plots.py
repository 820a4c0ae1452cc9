"""Scaling/benchmark report plots.

Parity with the reference's 4-panel matplotlib/seaborn scaling report
(cuVS_Scaling_Stress_Test.ipynb#cell17: build time, search latency, memory,
breaking point) plus the recall/latency operating curve the reference never
had. Headless-safe (Agg backend); matplotlib is optional.
"""

from __future__ import annotations

from typing import Sequence


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def scaling_report(rows: Sequence, path: str, title: str = "Scaling stress report") -> str:
    """4-panel report from eval.bench.StressRow records -> saved PNG path."""
    plt = _mpl()
    ok = [r for r in rows if r.ok]
    sizes = [r.n_vectors for r in ok]
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    fig.suptitle(title)

    axes[0, 0].plot(sizes, [r.build_s for r in ok], marker="o")
    axes[0, 0].set_title("build time (s)")
    axes[0, 0].set_xlabel("vectors")

    axes[0, 1].plot(sizes, [r.search_ms for r in ok], marker="o", color="tab:orange")
    axes[0, 1].set_title("search latency (ms/batch)")
    axes[0, 1].set_xlabel("vectors")

    recalls = [r.recall_at_10 for r in ok if r.recall_at_10 is not None]
    if recalls:
        axes[1, 0].plot(sizes[: len(recalls)], recalls, marker="o", color="tab:green")
        axes[1, 0].set_ylim(0, 1.05)
    axes[1, 0].set_title("recall@10 vs exact GT")
    axes[1, 0].set_xlabel("vectors")

    bad = [r for r in rows if not r.ok]
    axes[1, 1].axis("off")
    msg = ("breaking point: none reached"
           if not bad else f"breaking point: {bad[0].n_vectors}\n{bad[0].error[:120]}")
    axes[1, 1].text(0.05, 0.6, msg, fontsize=11, wrap=True)
    axes[1, 1].set_title("breaking point")

    for ax in axes.flat:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def operating_curve_plot(points: Sequence, path: str,
                         min_recall: float = 0.95) -> str:
    """Recall-vs-QPS frontier from eval.sweeps.SweepPoint records."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 5))
    xs = [p.qps for p in points]
    ys = [p.recall for p in points]
    ax.plot(xs, ys, marker="o")
    for p in points:
        ax.annotate(str(p.param), (p.qps, p.recall), fontsize=8,
                    textcoords="offset points", xytext=(4, 4))
    ax.axhline(min_recall, linestyle="--", color="tab:red", alpha=0.6,
               label=f"recall target {min_recall}")
    ax.set_xlabel("QPS")
    ax.set_ylabel("recall@k")
    ax.set_title("recall / throughput operating curve")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
