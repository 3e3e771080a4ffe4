#!/usr/bin/env python3
"""How far the point order alone moves the port's first-PointNet
gradients in a float32 train-mode forward, beside the gap between the
kernel and the scatter pooling paths.

    python3 tools/torch_pool_grad_order.py

Runs on one CUDA card at the full ``config.modelnet40()`` width, in
float32 with TF32 off, from the seeded weights and synthetic clouds that
``chip_smoke.py`` uses.  For each batch and dropout rate it prints the
worst relative error (per tensor, against its norm) of the first
PointNet's gradients between: the kernel path and the scatter path; the
scatter path and itself with the points permuted; the kernel path and
itself with the points permuted.  In exact arithmetic all three are 0.
Batch statistics are sums over the points, so another order moves them
in their last bits, and max-pooling winners that are nearly tied can
move with them.  The first batch is the one ``chip_smoke.py`` phase 5
holds.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sonet_torch import config, train  # noqa: E402
from sonet_torch.models import build_model  # noqa: E402

PREFIX = "encoder.first_pointnet."


def first_pointnet_grads(cfg, state_dict, batch, perm):
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state_dict)
    model.train()
    pc, sn = batch["pc"], batch["sn"]
    if perm is not None:
        pc, sn = pc[:, perm], sn[:, perm]
    gen = torch.Generator(device="cuda").manual_seed(7)
    score, _ = model(pc, sn, batch["node"], epoch=0, generator=gen)
    train.losses.cross_entropy(score, batch["label"]).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if n.startswith(PREFIX) and p.grad is not None
            and n != cs.NOISE_BIAS}


def worst(got, want):
    errs = {n: cs._rel_err(got[n], w) for n, w in want.items()}
    n = max(errs, key=errs.get)
    return f"{errs[n]:.3e} ({n[len(PREFIX):]})"


def batches(cfg, dev):
    """chip_smoke.py phase 5's first batch, then two more."""
    B = cfg.batch_size
    for n_items, seed in ((3 * B, 3), (B, 11), (B, 12)):
        clouds = cs._clouds(np, n_items, cfg, seed=seed)
        labels = np.random.RandomState(seed + 1).randint(0, cfg.classes,
                                                         n_items)
        b = {n: torch.from_numpy(a[:B]).to(dev) for n, a in clouds.items()}
        b["label"] = torch.from_numpy(labels[:B]).to(dev)
        yield seed, b


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pool_grad_order: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device()
    dev = torch.device("cuda")
    cfg = config.modelnet40()
    state_dict = train.init_state(cfg, device=dev, seed=0,
                                  steps_per_epoch=100).model.state_dict()
    for seed, batch in batches(cfg, dev):
        perm = torch.randperm(cfg.input_pc_num, device=dev, generator=(
            torch.Generator(device=dev).manual_seed(seed)))
        for dropout in (cfg.dropout, 0.0):
            c = cfg.replace(compute_dtype="float32", dropout=dropout)
            kern = c.replace(pooling="sorted_window")
            scat = c.replace(pooling="scatter")
            k = first_pointnet_grads(kern, state_dict, batch, None)
            s = first_pointnet_grads(scat, state_dict, batch, None)
            sp = first_pointnet_grads(scat, state_dict, batch, perm)
            kp = first_pointnet_grads(kern, state_dict, batch, perm)
            print(f"clouds seed {seed}, dropout {dropout}: kernel vs scatter "
                  f"{worst(k, s)}; scatter vs scatter permuted "
                  f"{worst(sp, s)}; kernel vs kernel permuted "
                  f"{worst(kp, k)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
