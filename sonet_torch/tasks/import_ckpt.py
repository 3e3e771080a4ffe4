"""Import the reference's ``.pth`` checkpoints into a run of the port
(port of the JAX package's ``tasks/import_ckpt.py``).

The reference saves one ``state_dict`` a sub-network
(``<epoch>_net_encoder.pth`` and ``_net_classifier.pth``,
``_net_segmenter.pth`` or ``_net_decoder.pth``).  This converts them
(``sonet_torch.compat``) and writes a run directory that ``infer``,
``serve``, ``export``, ``--pretrain`` and resumed training take:

    sonet-torch import-ckpt --preset modelnet40 \\
        --encoder ckpts/300_net_encoder.pth \\
        --classifier ckpts/300_net_classifier.pth \\
        --out checkpoints/imported_modelnet40
    sonet-torch infer --run checkpoints/imported_modelnet40

The ``Config`` flags after the import's own work as in the training
drivers (``--preset`` picks the base; the default follows the head
imported).  The config must describe the architecture the files were
trained with (classes, som_k, surface_normal, feature_num, ...): a
mismatch fails with a report of every leaf before anything is written.
"""

from __future__ import annotations

import json

from . import device_parser


def main(argv=None):
    ap = device_parser()
    ap.add_argument("--encoder", required=True,
                    help="reference *_net_encoder.pth")
    ap.add_argument("--classifier", help="*_net_classifier.pth "
                                         "(classify/retrieve tasks)")
    ap.add_argument("--segmenter", help="*_net_segmenter.pth (segment)")
    ap.add_argument("--decoder", help="*_net_decoder.pth (autoencode)")
    ap.add_argument("--out", required=True, help="run directory to write")
    ap.add_argument("--step", type=int, default=0,
                    help="step number recorded in the checkpoint")
    args, rest = ap.parse_known_args(argv)

    from .. import compat
    from ..config import parse_args

    # the default preset follows the head being imported
    preset = ("shapenetpart" if args.segmenter
              else "autoencoder" if args.decoder else "modelnet40")
    cfg = parse_args(rest, preset=preset)

    files = {"encoder": args.encoder}
    for label in ("classifier", "segmenter", "decoder"):
        if getattr(args, label):
            files[label] = getattr(args, label)
    ckpt = compat.import_run(cfg, files, args.out, step=args.step,
                             device=args.device)
    summary = {"run": args.out, "checkpoint": ckpt, "task": cfg.task,
               "imported": files}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
