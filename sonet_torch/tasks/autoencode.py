"""Autoencoder training driver (the reference's autoencoder/train.py; port
of the JAX package's ``tasks/autoencode.py``).

    sonet-torch autoencode --preset autoencoder --dataroot /path/to/data
"""

from __future__ import annotations

from ..config import parse_args
from ..train.trainer import Trainer
from . import device_parser, pictures


def main(argv=None):
    known, rest = device_parser().parse_known_args(argv)
    cfg = parse_args(rest, preset="autoencoder")
    viz = pictures("eval pictures")
    trainer = Trainer(cfg, device=known.device)
    # the reference saves every epoch (autoencoder/train.py:106-109);
    # threshold None = save on every improvement
    final = trainer.fit(save_threshold=None,
                        visualize_every=5 if viz else 0)
    print({"final": final, "best": trainer.best_metric})
    return final


if __name__ == "__main__":
    main()
