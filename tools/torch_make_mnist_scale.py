#!/usr/bin/env python3
"""Generate a procedural MNIST-style dataset (keras npz layout) for the
PyTorch port's 2-D point-cloud soak; counterpart of
``tools/make_mnist_scale.py``, with the same flags and the same arrays
for the same seed.

    python3 tools/torch_make_mnist_scale.py --out data/mnist_scale \\
        [--train 8000] [--test 2000] [--seed 0]

Digits are rendered as seven-segment glyphs on a 28x28 grid with random
position, size, thickness and pixel noise, so the 10 classes are
distinct but one-segment-apart pairs are confusable.  Output:
``<out>/mnist.npz`` {x_train, y_train, x_test, y_test}, what
``sonet_torch.data.mnist.load_mnist_split`` reads; the train soak is
``tools/torch_soak.py --preset mnist --dataroot <out>``.
"""

import argparse
import os

import numpy as np

# seven-segment map: (a, b, c, d, e, f, g)
SEGMENTS = {
    0: "abcdef", 1: "bc", 2: "abged", 3: "abgcd", 4: "fgbc",
    5: "afgcd", 6: "afgedc", 7: "abc", 8: "abcdefg", 9: "abcfgd",
}
# segment -> (row0, col0, row1, col1) on a 0..1 glyph box
SEG_POS = {
    "a": (0.0, 0.0, 0.0, 1.0), "b": (0.0, 1.0, 0.5, 1.0),
    "c": (0.5, 1.0, 1.0, 1.0), "d": (1.0, 0.0, 1.0, 1.0),
    "e": (0.5, 0.0, 1.0, 0.0), "f": (0.0, 0.0, 0.5, 0.0),
    "g": (0.5, 0.0, 0.5, 1.0),
}


def render_digit(d, rng, size=28):
    """Digit ``d`` as a (size, size) uint8 image drawn from ``rng``: a
    glyph box of random height, width and place, segments of random
    thickness, 8% of the pixels dropped and 1% speckled."""
    img = np.zeros((size, size), np.float32)
    h = rng.uniform(12, 18)
    w = rng.uniform(7, 11)
    r0 = rng.uniform(3, size - 3 - h)
    c0 = rng.uniform(3, size - 3 - w)
    thick = rng.uniform(1.2, 2.2)
    yy, xx = np.mgrid[0:size, 0:size]
    for seg in SEGMENTS[d]:
        a0, b0, a1, b1 = SEG_POS[seg]
        p0 = np.array([r0 + a0 * h, c0 + b0 * w])
        p1 = np.array([r0 + a1 * h, c0 + b1 * w])
        v = p1 - p0
        L2 = (v * v).sum() + 1e-9
        t = np.clip(((yy - p0[0]) * v[0] + (xx - p0[1]) * v[1]) / L2, 0, 1)
        dist2 = (yy - (p0[0] + t * v[0])) ** 2 + (xx - (p0[1] + t * v[1])) ** 2
        img = np.maximum(img, (dist2 < thick ** 2).astype(np.float32))
    img *= (rng.random(img.shape) > 0.08)
    img = np.maximum(img, (rng.random(img.shape) < 0.01).astype(np.float32))
    return (img * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=8000)
    p.add_argument("--test", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)

    def split(n):
        y = (np.arange(n) % 10).astype(np.uint8)
        x = np.stack([render_digit(int(d), rng) for d in y])
        return x, y

    x_train, y_train = split(args.train)
    x_test, y_test = split(args.test)
    np.savez(os.path.join(args.out, "mnist.npz"),
             x_train=x_train, y_train=y_train,
             x_test=x_test, y_test=y_test)
    print(f"wrote {args.train}+{args.test} digits to {args.out}/mnist.npz")


if __name__ == "__main__":
    main()
