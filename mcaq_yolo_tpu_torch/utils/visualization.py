"""
Visualization (a copy of `mcaq_yolo_tpu/utils/visualization.py`):
complexity-map overlays (hot colormap), bit-allocation maps (viridis, 2-8,
with a histogram), training curves, complexity against performance, and a
multi-panel summary report.  Host-side matplotlib, imported at the first
call (Agg backend); without matplotlib each function raises naming it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _require_mpl():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("matplotlib is not installed: visualization needs it") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    yi = (np.arange(h) * m.shape[0] // h).clip(0, m.shape[0] - 1)
    xi = (np.arange(w) * m.shape[1] // w).clip(0, m.shape[1] - 1)
    return m[yi][:, xi]


def visualize_complexity_map(
    image: np.ndarray, complexity_map: np.ndarray, save_path: Optional[str] = None,
    alpha: float = 0.5,
):
    """Overlay the tile complexity map (hot colormap) on the image."""
    plt = _require_mpl()
    h, w = image.shape[:2]
    cmap_up = _resize_nearest(np.asarray(complexity_map, np.float32), h, w)

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(image)
    axes[0].set_title("Input")
    im1 = axes[1].imshow(cmap_up, cmap="hot", vmin=0, vmax=1)
    axes[1].set_title("Complexity C(x)")
    plt.colorbar(im1, ax=axes[1], fraction=0.046)
    axes[2].imshow(image)
    axes[2].imshow(cmap_up, cmap="hot", vmin=0, vmax=1, alpha=alpha)
    axes[2].set_title("Overlay")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_bit_allocation(
    image: np.ndarray, bit_map: np.ndarray, save_path: Optional[str] = None,
):
    """Bit map (viridis, fixed 2-8 range) + integer-bit histogram."""
    plt = _require_mpl()
    h, w = image.shape[:2]
    bmap = np.asarray(bit_map, np.float32)
    bmap_up = _resize_nearest(bmap, h, w)

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(image)
    axes[0].set_title("Input")
    axes[0].axis("off")
    im1 = axes[1].imshow(bmap_up, cmap="viridis", vmin=2, vmax=8)
    axes[1].set_title(f"Bit allocation (avg {bmap.mean():.2f})")
    axes[1].axis("off")
    plt.colorbar(im1, ax=axes[1], fraction=0.046)

    bits = np.clip(np.round(bmap.reshape(-1)), 2, 8).astype(int)
    counts = [int((bits == b).sum()) for b in range(2, 9)]
    axes[2].bar(range(2, 9), counts, color="tab:purple")
    axes[2].set_xlabel("bits")
    axes[2].set_ylabel("tiles")
    axes[2].set_title("Bit histogram")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_training_curves(history: List[Dict], save_path: Optional[str] = None):
    """Loss / mAP / bits / temperature curves from Trainer.history."""
    plt = _require_mpl()
    epochs = [h.get("epoch", i) for i, h in enumerate(history)]

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    panels = [
        ("loss_total", "Total loss"),
        ("map50", "val mAP@0.5"),
        ("avg_bits", "Average bits"),
        ("temperature", "Temperature alpha_t"),
    ]
    for ax, (key, title) in zip(axes.ravel(), panels):
        ys = [h.get(key) for h in history]
        xs = [e for e, y in zip(epochs, ys) if y is not None]
        ys = [y for y in ys if y is not None]
        if ys:
            ax.plot(xs, ys)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_complexity_vs_performance(
    complexity: Sequence[float], performance: Sequence[float],
    save_path: Optional[str] = None, xlabel: str = "complexity",
    ylabel: str = "AP@0.5",
):
    """Scatter + 2-D density of per-image complexity vs detection quality."""
    plt = _require_mpl()
    c = np.asarray(complexity, np.float64)
    p = np.asarray(performance, np.float64)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].scatter(c, p, s=12, alpha=0.6)
    if len(c) > 1:
        k = np.polyfit(c, p, 1)
        xs = np.linspace(c.min(), c.max(), 50)
        axes[0].plot(xs, np.polyval(k, xs), "r--", label=f"slope {k[0]:.3f}")
        axes[0].legend()
    axes[0].set_xlabel(xlabel)
    axes[0].set_ylabel(ylabel)
    axes[0].grid(alpha=0.3)

    h = axes[1].hist2d(c, p, bins=20, cmap="viridis")
    plt.colorbar(h[3], ax=axes[1])
    axes[1].set_xlabel(xlabel)
    axes[1].set_ylabel(ylabel)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def create_summary_report(
    history: List[Dict], eval_results: Dict, save_path: str,
    bit_map: Optional[np.ndarray] = None,
):
    """Multi-panel report: curves + final metrics table + bit histogram."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(14, 10))

    gs = fig.add_gridspec(3, 2)
    ax1 = fig.add_subplot(gs[0, 0])
    ax2 = fig.add_subplot(gs[0, 1])
    ax3 = fig.add_subplot(gs[1, 0])
    ax4 = fig.add_subplot(gs[1, 1])
    ax5 = fig.add_subplot(gs[2, :])

    epochs = [h.get("epoch", i) for i, h in enumerate(history)]

    def line(ax, key, title):
        ys = [h.get(key) for h in history]
        xs = [e for e, y in zip(epochs, ys) if y is not None]
        ys = [y for y in ys if y is not None]
        if ys:
            ax.plot(xs, ys)
        ax.set_title(title)
        ax.grid(alpha=0.3)

    line(ax1, "loss_total", "Total loss")
    line(ax2, "map50", "val mAP@0.5")
    line(ax3, "avg_bits", "Average bits")

    if bit_map is not None:
        bits = np.clip(np.round(np.asarray(bit_map).reshape(-1)), 2, 8).astype(int)
        ax4.bar(range(2, 9), [int((bits == b).sum()) for b in range(2, 9)])
        ax4.set_title("Final bit histogram")
    else:
        ax4.axis("off")

    ax5.axis("off")
    rows = [[k, f"{v:.4f}" if isinstance(v, float) else str(v)]
            for k, v in eval_results.items() if not isinstance(v, (dict, list))]
    table = ax5.table(cellText=rows, colLabels=["metric", "value"],
                      loc="center", cellLoc="left")
    table.scale(1, 1.4)
    ax5.set_title("Final evaluation")

    fig.tight_layout()
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path
