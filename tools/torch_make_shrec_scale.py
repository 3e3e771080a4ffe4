#!/usr/bin/env python3
"""Generate a SHREC2016-layout dataset (55 categories) for the retrieval
soak of the PyTorch port (``sonet_torch``); counterpart of
``tools/make_shrec_scale.py``, with the same flags and the same arrays for
the same seed.

    python3 tools/torch_make_shrec_scale.py --out data/shrec_scale \\
        --hardness 0.35 [--seed 0]

Each class gets ``--per_class`` shapes, split 60/15/15 in that order
(train, val, test), and ids are allocated in per-class blocks of
``--per_class`` across the three splits, so a test shape's true class is
its id // ``per_class`` (the test list itself carries no label).

Layout (data/modelnet.py::make_dataset_shrec2016,
modelnet_shrec_loader.py:67-113):
    <out>/category.txt
    <out>/{train,val,test}.txt       ("name,category" lines; test: names)
    <out>/<rows>x<rows>/<mode>/model_<name>.npz   {pc, sn}
SOM nodes are added in place by ``python -m sonet_torch.data.prep som``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sonet_torch.data.sampler import normalize_cloud, sample_mesh  # noqa: E402

from torch_make_modelnet_scale import superellipsoid_mesh  # noqa: E402


def class_params(cls, rng, hardness=0.0):
    """hardness > 0: confusable pairs + wider jitter; 0 = well
    separated."""
    base = cls if hardness <= 0 else cls - (cls % 2)
    e1 = 0.3 + 0.3 * (base % 11)
    e2 = 0.3 + 0.6 * (base // 11)
    aspect = np.array([1.0,
                       0.4 + 0.3 * ((base * 7) % 5),
                       0.5 + 0.22 * ((base * 3) % 4)])
    if hardness > 0 and cls % 2:
        m = 1.0 - hardness
        e1 *= 1.0 + 0.3 * m
        e2 *= 1.0 + 0.25 * m
        aspect = aspect * np.array([1.0, 1.0 + 0.25 * m, 1.0 - 0.15 * m])
    j = 0.08 * (1.0 + 3.0 * hardness)
    return (e1 * rng.uniform(1 - j, 1 + j), e2 * rng.uniform(1 - j, 1 + j),
            aspect * rng.uniform(max(1 - 1.25 * j, 0.2), 1 + 1.25 * j, 3))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--classes", type=int, default=55)
    p.add_argument("--per_class", type=int, default=90,
                   help="train+val+test items per class (60/15/15 split)")
    p.add_argument("--points", type=int, default=10000)
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hardness", type=float, default=0.0,
                   help="0 = well-separated; >0 = confusable pairs + "
                        "wider jitter")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    cats = [f"cat{c:03d}" for c in range(args.classes)]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "category.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    n_train = args.per_class * 2 // 3
    n_val = (args.per_class - n_train) // 2
    lists = {"train": [], "val": [], "test": []}
    idx = 0
    for c, cat in enumerate(cats):
        for i in range(args.per_class):
            mode = ("train" if i < n_train
                    else "val" if i < n_train + n_val else "test")
            e1, e2, aspect = class_params(c, rng, args.hardness)
            verts, faces = superellipsoid_mesh(e1, e2, aspect)
            verts = verts + (0.01 * (1 + 3 * args.hardness)
                             * rng.standard_normal(verts.shape))
            pts, normals = sample_mesh(verts, faces, args.points, rng)
            pts = normalize_cloud(pts)
            name = f"{idx:06d}"
            idx += 1
            d = os.path.join(args.out, f"{args.rows}x{args.rows}", mode)
            os.makedirs(d, exist_ok=True)
            np.savez(os.path.join(d, f"model_{name}.npz"),
                     pc=pts.astype(np.float32),
                     sn=normals.astype(np.float32))
            lists[mode].append(f"{name},{cat}" if mode != "test" else name)
        print(f"{cat}: {args.per_class} shapes ({idx} total)", flush=True)
    for mode, lines in lists.items():
        with open(os.path.join(args.out, f"{mode}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    print(f"wrote {idx} shapes to {args.out}")


if __name__ == "__main__":
    main()
