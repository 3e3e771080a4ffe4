#!/usr/bin/env python3
"""Generate a ModelNet40-scale dataset in the reference layout, for the
PyTorch port (``sonet_torch``); counterpart of
``tools/make_modelnet_scale.py``, with the same flags and the same files
for the same seed.

    python3 tools/torch_make_modelnet_scale.py --out data/mn40_scale \\
        --hardness 0.15 [--seed 0]

40 superellipsoid classes at the reference's full scale (9,840 train +
2,480 test shapes by default, a (10000, 6) float32 ``.npy`` a shape),
sampled by ``sonet_torch.data.sampler``, which draws from the generator
as the JAX package's sampler does.  SOM nodes are added separately with
``python -m sonet_torch.data.prep som --root <out>`` (on the card).

Layout written (data/modelnet.py, modelnet_shrec_loader.py:28-64):
    <out>/modelnet40_shape_names.txt
    <out>/modelnet40_{train,test}.txt
    <out>/<class>/<class>_<nnnn>.npy          (10000, 6) float32
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sonet_torch.data.sampler import normalize_cloud, sample_mesh  # noqa: E402


def superellipsoid_mesh(e1, e2, aspect, nu=24, nv=48):
    """Parametric superellipsoid -> (vertices, triangle faces)."""
    u = np.linspace(-np.pi / 2, np.pi / 2, nu)
    v = np.linspace(-np.pi, np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")

    def spow(x, p):
        return np.sign(x) * np.abs(x) ** p

    x = spow(np.cos(uu), e1) * spow(np.cos(vv), e2) * aspect[0]
    y = spow(np.sin(uu), e1) * aspect[1]
    z = spow(np.cos(uu), e1) * spow(np.sin(vv), e2) * aspect[2]
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], 1)

    faces = []
    for i in range(nu - 1):
        for j in range(nv):
            jn = (j + 1) % nv
            a, b = i * nv + j, i * nv + jn
            c, d = (i + 1) * nv + j, (i + 1) * nv + jn
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, np.asarray(faces, np.int64)


def class_params(cls, rng, hardness=0.0):
    """Distinct (e1, e2, aspect) per class + per-instance jitter.

    ``hardness`` in [0, 1]: at 0 the classes are well separated; above 0
    they come in confusable pairs (the odd class takes its even partner's
    base shape, apart by a margin that shrinks with hardness) and the
    per-instance jitter widens into the inter-class margin."""
    base = cls if hardness <= 0 else cls - (cls % 2)
    base_e1 = 0.3 + 0.45 * (base % 8)            # 0.3 .. 3.45
    base_e2 = 0.3 + 0.7 * (base // 8)            # 0.3 .. 3.1
    aspect = np.array([1.0,
                       0.4 + 0.35 * ((base * 3) % 5),
                       0.5 + 0.25 * ((base * 7) % 4)])
    if hardness > 0 and cls % 2:
        m = 1.0 - hardness  # pair margin -> 0 as hardness -> 1
        base_e1 *= 1.0 + 0.45 * m
        base_e2 *= 1.0 + 0.35 * m
        aspect = aspect * np.array([1.0, 1.0 + 0.3 * m, 1.0 - 0.2 * m])
    j = 0.1 * (1.0 + 3.0 * hardness)
    e1 = base_e1 * rng.uniform(1 - j, 1 + j)
    e2 = base_e2 * rng.uniform(1 - j, 1 + j)
    aspect = aspect * rng.uniform(max(1 - 1.5 * j, 0.2), 1 + 1.5 * j, 3)
    return e1, e2, aspect


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--classes", type=int, default=40)
    p.add_argument("--train_per_class", type=int, default=246)
    p.add_argument("--test_per_class", type=int, default=62)
    p.add_argument("--points", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hardness", type=float, default=0.0,
                   help="0 = well-separated classes; >0 = confusable "
                        "pairs + wider intra-class jitter")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    shape_names = [f"shape{c:03d}" for c in range(args.classes)]
    with open(os.path.join(args.out,
                           f"modelnet{args.classes}_shape_names.txt"),
              "w") as f:
        f.write("\n".join(shape_names) + "\n")

    lists = {"train": [], "test": []}
    total = 0
    for c, cname in enumerate(shape_names):
        os.makedirs(os.path.join(args.out, cname), exist_ok=True)
        n_items = args.train_per_class + args.test_per_class
        for i in range(n_items):
            mode = "train" if i < args.train_per_class else "test"
            e1, e2, aspect = class_params(c, rng, args.hardness)
            verts, faces = superellipsoid_mesh(e1, e2, aspect)
            verts = verts + (0.01 * (1 + 3 * args.hardness)
                             * rng.standard_normal(verts.shape))
            pts, normals = sample_mesh(verts, faces, args.points, rng)
            pts = normalize_cloud(pts)
            name = f"{cname}_{i + 1:04d}"
            np.save(os.path.join(args.out, cname, name + ".npy"),
                    np.concatenate([pts, normals], 1).astype(np.float32))
            lists[mode].append(name)
            total += 1
        print(f"{cname}: {n_items} shapes ({total} total)", flush=True)

    for mode, names in lists.items():
        with open(os.path.join(args.out,
                               f"modelnet{args.classes}_{mode}.txt"),
                  "w") as f:
            f.write("\n".join(names) + "\n")
    print(f"wrote {total} shapes to {args.out}")


if __name__ == "__main__":
    main()
