"""Point-cloud pictures and an HTML gallery (port of the JAX package's
``utils/visualize.py``).

Matplotlib PNGs and a dependency-free HTML index take the place of the
reference's visdom scatter plots (util/visualizer.py:27-40: autoencoder
reconstructions, segmentation colourings) and its dominate gallery
(util/html.py).  Matplotlib is imported inside the functions that draw,
so importing this module needs numpy only.

Segmentation colours follow losses.py:46-70 / segmenter.py:135-155:
per-part colours from ``part_color_mapping.json`` when the dataroot has
one, otherwise a fixed fallback palette.
"""

from __future__ import annotations

import html
import importlib.util
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def available() -> bool:
    """Whether matplotlib, which every picture needs, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def _palette(n: int) -> np.ndarray:
    rng = np.random.RandomState(7)
    return rng.uniform(0.1, 0.95, (n, 3))


def load_part_colors(dataroot: str, num_parts: int = 50) -> np.ndarray:
    """part_color_mapping.json (losses.py:57-59) or fallback palette."""
    path = os.path.join(dataroot or "", "part_color_mapping.json")
    if dataroot and os.path.exists(path):
        with open(path) as f:
            return np.abs(np.asarray(json.load(f), np.float64))
    return _palette(num_parts)


def save_point_cloud_png(path: str, pc: np.ndarray,
                         colors: Optional[np.ndarray] = None,
                         title: str = "", size: float = 2.0) -> str:
    """Scatter a (N, 2|3) cloud to a PNG (matplotlib, headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pc = np.asarray(pc)
    fig = plt.figure(figsize=(5, 5))
    if pc.shape[1] >= 3:
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 2], pc[:, 1], s=size, c=colors)
        ax.set_box_aspect((1, 1, 1))
    else:
        ax = fig.add_subplot(111)
        ax.scatter(pc[:, 0], pc[:, 1], s=size, c=colors)
        ax.set_aspect("equal")
    ax.set_title(title)
    ax.set_axis_off()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_seg_comparison(out_dir: str, tag: str, pc: np.ndarray,
                        seg_pred: np.ndarray, seg_gt: np.ndarray,
                        dataroot: str = "") -> List[str]:
    """Predicted-vs-gt colored clouds (losses.py:46-70 behavior)."""
    colors = load_part_colors(dataroot)
    paths = []
    for name, seg in (("predicted", seg_pred), ("gt", seg_gt)):
        c = colors[np.asarray(seg).astype(int) % len(colors)]
        paths.append(save_point_cloud_png(
            os.path.join(out_dir, f"{tag}_{name}.png"), pc, c,
            title=f"{tag} {name}"))
    return paths


class HTMLGallery:
    """Minimal html.py replacement: an index of titled image rows."""

    def __init__(self, out_dir: str, title: str = "sonet_torch results"):
        self.out_dir = out_dir
        self.title = title
        self.rows: List[Dict] = []
        os.makedirs(out_dir, exist_ok=True)

    def add_row(self, header: str, images: Sequence[str],
                captions: Optional[Sequence[str]] = None) -> None:
        rel = [os.path.relpath(p, self.out_dir) for p in images]
        caps = list(captions) if captions else [os.path.basename(p)
                                                for p in rel]
        self.rows.append({"header": header, "images": rel,
                          "captions": caps})

    def save(self) -> str:
        parts = [f"<html><head><title>{html.escape(self.title)}</title>",
                 "<style>img{width:256px;margin:4px}td{text-align:center}"
                 "</style></head><body>",
                 f"<h1>{html.escape(self.title)}</h1>"]
        for row in self.rows:
            parts.append(f"<h3>{html.escape(row['header'])}</h3>"
                         "<table><tr>")
            for img, cap in zip(row["images"], row["captions"]):
                parts.append(
                    f"<td><a href='{img}'><img src='{img}'></a><br>"
                    f"{html.escape(cap)}</td>")
            parts.append("</tr></table>")
        parts.append("</body></html>")
        path = os.path.join(self.out_dir, "index.html")
        with open(path, "w") as f:
            f.write("\n".join(parts))
        return path
