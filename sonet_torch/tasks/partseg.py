"""Part-segmentation training driver (the reference's part-seg/train.py;
port of the JAX package's ``tasks/partseg.py``).

    sonet-torch partseg --preset shapenetpart --dataroot /path/to/data
"""

from __future__ import annotations

from ..config import parse_args
from ..parallel import is_main
from ..train.trainer import Trainer
from . import device_parser, pictures


def main(argv=None):
    known, rest = device_parser().parse_known_args(argv)
    cfg = parse_args(rest, preset="shapenetpart")
    viz = pictures("eval pictures")
    trainer = Trainer(cfg, device=known.device)
    # mIoU save threshold (part-seg/train.py:110)
    final = trainer.fit(save_threshold=0.835,
                        visualize_every=5 if viz else 0)
    if is_main():                # one process of a --distributed run
        print({"final": final, "best": trainer.best_metric})
    return final


if __name__ == "__main__":
    main()
