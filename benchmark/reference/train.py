"""The reference's training: a batch drawn from the raw split, the step's
loss and gradients by autograd, and Adam, in plain float32 PyTorch.

``sample`` builds a train batch from raw rows as the SO-Net loaders do
on the host (modelnet_shrec_loader.py): a uniform subset of the points
without repeats, jitter on points, normals and nodes, and a per-cloud
scale.  The random numbers come from a ``torch.Generator`` in a fixed
order (subset keys, point jitter, normal jitter, node jitter, scale, then
the dropout masks of the forward), so a generator seeded as the
measured program's draws what it draws.

``train_steps`` runs the first steps of a training run from given
weights: each step's loss, the first step's gradients, and each
parameter's change after the last step; ``checked_steps`` composes what
the benchmark checks (several first steps from one start, then a run of
steps).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import model
from .precision import Precision

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def sample(raw: Dict[str, torch.Tensor], generator: torch.Generator,
           cfg: dict, train: bool) -> Dict[str, torch.Tensor]:
    """A batch from raw rows ``raw`` (pc, sn (B, n_raw, 3), node (B, M, 3),
    label (B,), seg (B, n_raw) or absent)."""
    for flag in ("rot_horizontal", "rot_perturbation",
                 "translation_perturbation"):
        if cfg.get(flag):
            raise NotImplementedError(f"{flag}: not in the reference")
    pc, sn, node = raw["pc"].float(), raw["sn"].float(), raw["node"].float()
    seg = raw.get("seg")
    B, n_raw, D = pc.shape
    N, M = min(cfg["input_pc_num"], n_raw), node.shape[1]
    kw = dict(generator=generator, device=pc.device)
    if N < n_raw:
        keys = torch.rand((B, n_raw), **kw)
        choice = torch.argsort(keys, dim=1, stable=True)[:, :N]
        rows = choice[..., None].expand(-1, -1, D)
        pc, sn = torch.gather(pc, 1, rows), torch.gather(sn, 1, rows)
        if seg is not None:
            seg = torch.gather(seg, 1, choice)
    if train:
        jpc = torch.randn((B, N, D), **kw)
        jsn = torch.randn((B, N, D), **kw)
        jnode = torch.randn((B, M, D), **kw)
        scale = torch.rand((B, 1, 1), **kw) * 0.4 + 0.8
        pc = pc + torch.clamp(0.01 * jpc, -0.05, 0.05)
        sn = sn + torch.clamp(0.01 * jsn, -0.05, 0.05)
        node = node + torch.clamp(0.04 * jnode, -0.1, 0.1)
        pc, sn, node = pc * scale, sn * scale, node * scale
    batch = {"pc": pc, "sn": sn, "node": node, "label": raw["label"]}
    if seg is not None:
        batch["seg"] = seg
    return batch


def learning_rate(cfg: dict, step: int, steps_per_epoch: int) -> float:
    """The halving schedule: epoch e trains at lr * ratio^((e - 1) //
    decay_step) for e >= 1 (epoch 0 at lr), never below the clip."""
    epoch = step // max(steps_per_epoch, 1)
    halvings = max(epoch - 1, 0) // max(cfg["lr_decay_step"], 1)
    return max(cfg["lr"] * cfg["lr_decay_ratio"] ** halvings, cfg["lr_clip"])


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                raws: List[Dict[str, torch.Tensor]], generator: torch.Generator,
                steps_per_epoch: int, prec: Optional[Precision] = None,
                loss_rows: Optional[int] = None) -> dict:
    """Train from ``weights`` (a fresh Adam) on one batch per raw-row dict
    of ``raws``, the draws taken from ``generator`` in turn.
    ``loss_rows`` takes the loss over the first rows of each batch only (a
    planted fault).  Returns ``loss`` (one float a step), ``grad`` (the
    first step's gradient by name) and ``change`` (each parameter after
    the last step minus its start)."""
    prec = prec or model.FP32
    names = model.trainable(model.param_specs(cfg))
    p = {n: t.detach().clone().float() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, first = [], None
    for t, raw in enumerate(raws):
        batch = sample(raw, generator, cfg, train=True)
        out = model.forward(p, cfg, batch, True, generator, prec)
        loss = model.loss(cfg, out, batch, loss_rows)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr = learning_rate(cfg, t, steps_per_epoch)
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / bc2 ** 0.5 + ADAM_EPS
                p[n].addcdiv_(m[n], denom, value=-lr / bc1)
        del out, loss, grads
    change = {n: (p[n].detach() - weights[n].float()) for n in names}
    return {"loss": losses, "grad": first, "change": change}


def checked_steps(weights: Dict[str, torch.Tensor], cfg: dict,
                  singles: List[dict], chain: List[dict], draw_seed: int,
                  steps_per_epoch: int, prec: Optional[Precision] = None,
                  loss_rows: Optional[int] = None) -> dict:
    """What the benchmark checks of a training run: a first step from
    ``weights`` on each batch of ``singles`` (each from the same start),
    then a run of ``len(chain)`` steps from that start, every draw from
    one generator seeded with ``draw_seed`` on the rows' device, in that
    order.  Returns ``first_losses`` (one a single), ``grad`` (the first
    single's gradient), ``chain_losses`` and ``change`` (after the
    chain)."""
    dev = next(iter(weights.values())).device
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    kw = dict(prec=prec, loss_rows=loss_rows)
    first_losses, grad = [], None
    for raw in singles:
        one = train_steps(weights, cfg, [raw], gen, steps_per_epoch, **kw)
        first_losses.append(one["loss"][0])
        grad = grad if grad is not None else one["grad"]
    run = train_steps(weights, cfg, chain, gen, steps_per_epoch, **kw)
    return {"first_losses": first_losses, "grad": grad,
            "chain_losses": run["loss"], "change": run["change"]}


def serve(weights: Dict[str, torch.Tensor], cfg: dict,
          batch: Dict[str, torch.Tensor], block: int = 32,
          prec: Optional[Precision] = None) -> torch.Tensor:
    """Eval-mode outputs of ``batch`` (pc, sn, node), ``block`` clouds at a
    time."""
    prec = prec or model.FP32
    outs = []
    with torch.no_grad():
        n = batch["pc"].shape[0]
        for i in range(0, n, block):
            part = {k: v[i:i + block] for k, v in batch.items()}
            outs.append(model.forward(weights, cfg, part, False, None, prec))
    return torch.cat(outs)
