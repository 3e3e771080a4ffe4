#!/usr/bin/env python3
"""Generate a ShapeNetPart-scale dataset in the reference layout, for the
PyTorch port (``sonet_torch``); counterpart of
``tools/make_shapenet_scale.py``, with the same flags and the same arrays
for the same seed.

    python3 tools/torch_make_shapenet_scale.py --out data/snpart_scale \\
        --hardness 0.7 [--seed 0]

16 categories of superellipsoid families at reference scale (12,096
train + 2,400 test shapes by default, 2048-point npz), with per-point
part labels drawn from each category's slots in the global 16 -> 50 part
table (``sonet_torch.ops.iou.PART_LABEL``, the reference's
losses.py:126-143), assigned by spatial region so they are learnable.
SOM nodes are added in place afterwards with
``python -m sonet_torch.data.prep som --root <out>`` (the npz branch
writes the ``som_node`` key beside {pc, sn, part_label}).

Layout written (data/shapenet.py, shapenet_loader.py:31-43, 131-139):
    <out>/train_test_split/shuffled_{train,test}_file_list.json
    <out>/<folder>/<name>_8x8.npz   {pc, sn, part_label}
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sonet_torch.data.sampler import normalize_cloud, sample_mesh  # noqa: E402
from sonet_torch.data.shapenet import FOLDERS  # noqa: E402
from sonet_torch.ops.iou import PART_LABEL  # noqa: E402

from torch_make_modelnet_scale import superellipsoid_mesh  # noqa: E402


def category_params(cat, rng, hardness=0.0):
    """Per-category (e1, e2, aspect) with per-instance jitter, which
    widens with ``hardness`` (0 = the narrowest)."""
    e1 = 0.35 + 0.38 * (cat % 6)
    e2 = 0.35 + 0.55 * (cat // 6)
    aspect = np.array([1.0,
                       0.45 + 0.3 * ((cat * 5) % 4),
                       0.55 + 0.2 * ((cat * 3) % 5)])
    j = 0.1 * (1.0 + 3.0 * hardness)
    return (e1 * rng.uniform(1 - j, 1 + j), e2 * rng.uniform(1 - j, 1 + j),
            aspect * rng.uniform(max(1 - 1.5 * j, 0.2), 1 + 1.5 * j, 3))


def part_labels_for(pts, cat, rng, hardness=0.0):
    """Spatially coherent part assignment: angular sectors about y,
    mapped to the category's global part ids.

    ``hardness > 0`` makes part boundaries ambiguous: each shape turns
    its sector boundaries by an unobservable offset and each point's
    angle is jittered, so the achievable mIoU falls below saturation."""
    parts = np.asarray(PART_LABEL[cat])
    theta = np.arctan2(pts[:, 2], pts[:, 0])  # [-pi, pi]
    if hardness > 0:
        theta = theta + (0.3 * hardness * rng.standard_normal()
                         + 0.2 * hardness * rng.standard_normal(len(pts)))
        # jittered angles wrap around the circle
        sector = np.floor((theta + np.pi) / (2 * np.pi)
                          * len(parts)).astype(int) % len(parts)
    else:
        sector = ((theta + np.pi) / (2 * np.pi) * len(parts)).astype(int)
        sector = np.clip(sector, 0, len(parts) - 1)
    # height split perturbs the mapping so parts aren't pure sectors
    upper = (pts[:, 1] > 0).astype(int)
    return parts[(sector + upper) % len(parts)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--train_per_cat", type=int, default=756)
    p.add_argument("--test_per_cat", type=int, default=150)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hardness", type=float, default=0.0,
                   help="0 = crisp part boundaries; >0 = ambiguous "
                        "boundaries + wider shape jitter")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(os.path.join(args.out, "train_test_split"), exist_ok=True)
    lists = {"train": [], "test": []}
    total = 0
    for cat, folder in enumerate(FOLDERS):
        os.makedirs(os.path.join(args.out, folder), exist_ok=True)
        n_items = args.train_per_cat + args.test_per_cat
        for i in range(n_items):
            mode = "train" if i < args.train_per_cat else "test"
            e1, e2, aspect = category_params(cat, rng, args.hardness)
            verts, faces = superellipsoid_mesh(e1, e2, aspect)
            verts = verts + (0.01 * (1 + 3 * args.hardness)
                             * rng.standard_normal(verts.shape))
            pts, normals = sample_mesh(verts, faces, args.points, rng)
            pts = normalize_cloud(pts)
            seg = part_labels_for(pts, cat, rng, args.hardness)
            name = f"{cat:02d}{i + 1:06d}"
            np.savez(os.path.join(
                args.out, folder, f"{name}_{args.rows}x{args.rows}.npz"),
                pc=pts.astype(np.float32), sn=normals.astype(np.float32),
                part_label=seg.astype(np.int64))
            lists[mode].append(f"shape_data/{folder}/{name}")
            total += 1
        print(f"{folder}: {n_items} shapes ({total} total)", flush=True)

    for mode, names in lists.items():
        rng.shuffle(names)
        with open(os.path.join(args.out, "train_test_split",
                               f"shuffled_{mode}_file_list.json"),
                  "w") as f:
            json.dump(names, f)
    print(f"wrote {total} shapes to {args.out}")


if __name__ == "__main__":
    main()
