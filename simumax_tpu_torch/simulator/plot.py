"""Memory-timeline plotting (optional; needs matplotlib).

The reference exports a ``torch.cuda.memory._snapshot()``-compatible
pickle for memory-viz; the TPU-native equivalent renders the
simulator's JSON snapshot directly to a PNG (per-stage allocated-HBM
step lines with the peak annotated).

Copy of the JAX package's ``simulator/plot.py``, unchanged. Where
matplotlib is not installed, the runner skips the plot.
"""

from __future__ import annotations

from typing import List, Optional


def plot_memory_timeline(snapshots: List[dict], out_path: str,
                         hbm_gib: Optional[float] = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4.5))
    for snap in snapshots:
        ts = [p["t_ms"] for p in snap["timeline"]]
        bs = [p["bytes"] / 2**30 for p in snap["timeline"]]
        ax.step(ts, bs, where="post", label=f"stage {snap['rank']}")
        peak_i = max(range(len(bs)), key=lambda i: bs[i])
        ax.annotate(
            f"{bs[peak_i]:.1f} GiB",
            (ts[peak_i], bs[peak_i]),
            textcoords="offset points", xytext=(4, 4), fontsize=8,
        )
    if hbm_gib:
        ax.axhline(hbm_gib, color="red", ls="--", lw=1, label="HBM capacity")
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("allocated HBM (GiB)")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("simulated per-stage HBM timeline")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
