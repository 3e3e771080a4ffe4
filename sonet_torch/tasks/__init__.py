"""Task drivers of the port (counterparts of the JAX package's ``tasks``;
the reference's modelnet/train.py, part-seg/train.py,
autoencoder/train.py and shrec16/test.py), and the port's batch inference
(``infer``), one-command reproduction (``reproduce``), serving artifacts
(``export``) and HTTP daemon (``serve``).

Each module has ``main(argv=None)``, reached as ``sonet-torch <command>``
(``sonet_torch.cli``) or ``python -m sonet_torch.tasks.<name>``.  Every
driver takes ``--device {cuda,cpu}`` (default ``cuda``; without a card
``cuda`` raises) besides the ``Config`` flags of ``config.parse_args``.
Pictures (eval visuals, the retrieval gallery) need matplotlib: without
it a driver says so when it starts and leaves them out.
"""

from __future__ import annotations

import argparse

__all__ = ["autoencode", "classify", "export", "infer", "partseg",
           "reproduce", "retrieve", "serve"]


def device_parser() -> argparse.ArgumentParser:
    """The flags a driver reads before ``config.parse_args``: ``--device``."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (default cuda; never falls back)")
    return p


def pictures(what: str) -> bool:
    """Whether matplotlib is there to draw ``what``; says so when not."""
    from ..utils import visualize
    if visualize.available():
        return True
    print(f"matplotlib is not installed: {what} left out", flush=True)
    return False
