"""Classification training driver (the reference's modelnet/train.py and
shrec16/train.py; port of the JAX package's ``tasks/classify.py``).

    sonet-torch classify --preset modelnet40 --dataroot /path/to/data
    sonet-torch classify --preset tiny_test --dataset synthetic --device cpu
"""

from __future__ import annotations

from ..config import parse_args
from ..train.trainer import Trainer
from . import device_parser


def main(argv=None):
    known, rest = device_parser().parse_known_args(argv)
    cfg = parse_args(rest, preset="modelnet40")
    # ModelNet10/40 automation (modelnet/train.py:36-37,106-109)
    if cfg.dataset == "modelnet" and cfg.classes == 10:
        cfg = cfg.replace(dropout=min(cfg.dropout + 0.1, 0.99),
                          lr_decay_step=40)
    # checkpoint-save thresholds (modelnet/train.py:96-99)
    threshold = None
    if cfg.dataset == "modelnet":
        threshold = 0.930 if cfg.classes == 10 else 0.918
    trainer = Trainer(cfg, device=known.device)
    final = trainer.fit(save_threshold=threshold)
    print({"final": final, "best": trainer.best_metric})
    return final


if __name__ == "__main__":
    main()
