"""Configuration for the PyTorch port: an own copy of the JAX package's
``config.py`` (``Config``, the per-task presets, ``load_config`` and the
command-line front end ``parse_args``), so the port never imports the JAX
package.  Field names, defaults and
presets are identical, so a ``config.json`` written by either package
loads in the other.

Of the TPU-specific fields, the port reads ``compute_dtype`` and
``pooling``; ``pooling="auto"`` resolves to the CUDA kernel on a CUDA
device and to the scatter form on the CPU (``nn.encoder.resolve_pooling``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

from .parallel.mesh import parse_mesh_shape


@dataclass
class Config:
    # ---- task / data ------------------------------------------------------
    task: str = "classify"  # classify | segment | autoencode | retrieve
    dataset: str = "modelnet"  # modelnet | shrec | shapenet | mnist | synthetic
    dataroot: str = ""
    classes: int = 40
    name: str = "train"
    checkpoints_dir: str = "./checkpoints"

    # ---- batch / points ---------------------------------------------------
    batch_size: int = 8
    input_pc_num: int = 5000
    surface_normal: bool = True

    # ---- architecture -----------------------------------------------------
    feature_num: int = 1024
    activation: str = "relu"  # relu | elu | swish | leakyrelu
    normalization: Optional[str] = "batch"  # batch | None
    dropout: float = 0.7
    node_num: int = 64  # must be a perfect square (reference networks.py:104)
    k: int = 3  # top-k point->node grouping (reference --k)
    som_k: int = 9  # kNN over SOM nodes; <2 disables the KNNModule
    som_k_type: str = "avg"  # avg | center

    # ---- autoencoder decoder ---------------------------------------------
    # 0 = derived (fc + selected conv output); set explicitly (reference
    # default 1280) and the Decoder validates consistency at trace time
    output_pc_num: int = 0
    output_fc_pc_num: int = 256
    output_conv_pc_num: int = 1024

    # ---- optimization -----------------------------------------------------
    lr: float = 1e-3
    pretrain: Optional[str] = None
    pretrain_lr_ratio: float = 1.0
    random_pc_dropout_lower_limit: float = 1.0
    bn_momentum: float = 0.1  # torch convention: ra = (1-m)*ra + m*batch
    bn_momentum_decay_step: Optional[int] = None
    bn_momentum_decay: float = 0.6
    lr_decay_step: int = 20  # epochs between lr halvings (modelnet/train.py:106-111)
    lr_decay_ratio: float = 0.5
    lr_clip: float = 1e-5  # classifier.py:136
    epochs: int = 301

    # ---- augmentation -----------------------------------------------------
    rot_horizontal: bool = False
    rot_perturbation: bool = False
    translation_perturbation: bool = False

    # ---- execution (no reference equivalent) -----------------------------
    # every production preset sets bfloat16 activations (params and BN
    # statistics stay float32); float32 is the parity configuration
    compute_dtype: str = "float32"  # float32 | bfloat16 for activations
    # node pooling: "auto" resolves to "sorted_window" (node-sorted
    # points + the CUDA segment-max kernel) on a CUDA device and to
    # "scatter" on the CPU (nn/encoder.py:resolve_pooling)
    pooling: str = "auto"  # auto | scatter | sorted_window
    # the fields below keep config.json files interchangeable with the
    # JAX package.  The port's Trainer takes every input_pipeline
    # (device_budget_gb bounds the device pipeline's split;
    # dataset_placement "sharded" needs a mesh and is read as replicated
    # without one) and a (data, points) mesh over the processes of a
    # --distributed run (parallel/); remat rematerialises the first
    # PointNet in training (nn/encoder.py, torch.utils.checkpoint)
    input_pipeline: str = "host"  # host | native | device
    device_budget_gb: float = 0.0
    dataset_placement: str = "replicated"  # replicated | sharded
    remat: bool = False
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, points) mesh
    mesh_axes: Tuple[str, ...] = ("data", "points")
    distributed: str = ""
    checkpoint_every: int = 0  # steps; 0 = per-epoch gated like the reference
    seed: int = 0

    # -----------------------------------------------------------------------
    @property
    def rows(self) -> int:
        r = int(round(math.sqrt(self.node_num)))
        if r * r != self.node_num:
            raise ValueError(f"node_num={self.node_num} must be a perfect square")
        return r

    @property
    def cols(self) -> int:
        return self.rows

    @property
    def kN(self) -> int:
        return self.k * self.input_pc_num

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def load_config(path: str) -> Config:
    """Rebuild a Config from a run directory's ``config.json`` (the
    opt.txt-parity file Trainer persists).  Unknown keys are ignored so
    configs stay loadable across field additions."""
    with open(path) as f:
        d = json.load(f)
    names = {f.name for f in dataclasses.fields(Config)}
    d = {k: v for k, v in d.items() if k in names}
    for k in ("mesh_shape", "mesh_axes"):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    for k in ("bn_momentum_decay_step", "pretrain", "normalization"):
        if d.get(k) in ("None", "none", ""):
            d[k] = None
    return Config(**d)


# ---------------------------------------------------------------------------
# Per-task presets mirroring the reference defaults.
# ---------------------------------------------------------------------------

def modelnet40() -> Config:
    """modelnet/options.py defaults with classes=40 (lr decay 20)."""
    return Config(task="classify", dataset="modelnet", classes=40,
                  input_pc_num=5000, dropout=0.7, som_k=9, som_k_type="avg",
                  lr_decay_step=20, epochs=301,
                  compute_dtype="bfloat16")


def modelnet10() -> Config:
    """ModelNet10: dropout +0.1, lr decay 40 (modelnet/train.py:36-37,106-109)."""
    return Config(task="classify", dataset="modelnet", classes=10,
                  input_pc_num=5000, dropout=0.8, som_k=9, som_k_type="avg",
                  lr_decay_step=40, epochs=301,
                  compute_dtype="bfloat16")


def shrec16() -> Config:
    """shrec16/options.py: 55 classes, som_k=0, dropout 0.6, 201 epochs."""
    return Config(task="retrieve", dataset="shrec", classes=55,
                  input_pc_num=5000, dropout=0.6, som_k=0, som_k_type="avg",
                  lr_decay_step=20, epochs=201,
                  compute_dtype="bfloat16")


def shapenetpart() -> Config:
    """part-seg/options.py: 50 part classes, 1024 pts, som_k_type center."""
    return Config(task="segment", dataset="shapenet", classes=50,
                  input_pc_num=1024, dropout=0.6, som_k=9, som_k_type="center",
                  lr_decay_step=20, epochs=601,
                  compute_dtype="bfloat16")


def autoencoder() -> Config:
    """autoencoder/options.py: 1280 output pts = 256 fc + 1024 conv."""
    return Config(task="autoencode", dataset="shapenet", classes=40,
                  input_pc_num=1024, dropout=0.5, som_k=9, som_k_type="avg",
                  output_pc_num=1280, output_fc_pc_num=256,
                  output_conv_pc_num=1024, lr_decay_step=20, epochs=601,
                  compute_dtype="bfloat16")


def mnist() -> Config:
    """MNIST 2D point clouds (README.md:21; no loader existed in the
    reference snapshot — see SURVEY.md §2.1). 512 points, 5x5 SOM."""
    return Config(task="classify", dataset="mnist", classes=10,
                  input_pc_num=512, surface_normal=False, dropout=0.5,
                  node_num=25, k=3, som_k=9, som_k_type="avg",
                  lr_decay_step=20, epochs=51,
                  compute_dtype="bfloat16")


def tiny_test() -> Config:
    """CPU-runnable config for unit/integration tests."""
    return Config(task="classify", dataset="synthetic", classes=4,
                  batch_size=4, input_pc_num=64, node_num=16, k=2, som_k=4,
                  feature_num=64, dropout=0.5, epochs=2,
                  output_fc_pc_num=16, output_conv_pc_num=1024)


PRESETS = {
    "modelnet40": modelnet40,
    "modelnet10": modelnet10,
    "shrec16": shrec16,
    "shapenetpart": shapenetpart,
    "autoencoder": autoencoder,
    "mnist": mnist,
    "tiny_test": tiny_test,
}


def parse_args(argv=None, preset: str = "modelnet40") -> Config:
    """Command-line front end: ``--preset`` picks the base config, and any
    field can be overridden with ``--<field> value`` (the reference's flag
    names).  The same argv gives the same ``Config`` as the JAX package's
    ``parse_args``."""
    base = argparse.ArgumentParser(add_help=False)
    base.add_argument("--preset", type=str, default=preset,
                      choices=sorted(PRESETS.keys()))
    known, _ = base.parse_known_args(argv)
    cfg = PRESETS[known.preset]()

    p = argparse.ArgumentParser(parents=[base])
    for f in dataclasses.fields(Config):
        t = f.type
        default = getattr(cfg, f.name)
        if t in ("bool", bool):
            p.add_argument(f"--{f.name}",
                           type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=default)
        elif t in ("int", int):
            p.add_argument(f"--{f.name}", type=int, default=default)
        elif t in ("float", float):
            p.add_argument(f"--{f.name}", type=float, default=default)
        elif f.name == "mesh_shape":
            p.add_argument("--mesh_shape", type=parse_mesh_shape,
                           default=default)
        elif f.name == "mesh_axes":
            continue  # set programmatically
        else:
            p.add_argument(f"--{f.name}", type=str, default=default)
    args = vars(p.parse_args(argv))
    args.pop("preset", None)
    overrides = {k: v for k, v in args.items() if hasattr(cfg, k)}
    # Optional[int] / Optional[str] fields: "None" means None
    for key in ("bn_momentum_decay_step", "pretrain", "normalization"):
        if overrides.get(key) in ("None", "none", ""):
            overrides[key] = None
    if overrides.get("bn_momentum_decay_step") is not None:
        overrides["bn_momentum_decay_step"] = int(
            overrides["bn_momentum_decay_step"])
    return cfg.replace(**overrides)
