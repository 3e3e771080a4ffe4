"""``sonet-torch``: the port's one console script for its task drivers
(counterpart of the JAX package's ``sonet``).

    sonet-torch classify   --preset modelnet40 --dataroot ...   # train
    sonet-torch partseg    --preset shapenetpart ...            # train
    sonet-torch autoencode --preset autoencoder ...             # train
    sonet-torch retrieve   --preset shrec16 --checkpoint ...    # rank
    sonet-torch reproduce  --preset modelnet40 --archive ...    # verdict
    sonet-torch infer      --run <dir> [--mode test]            # predictions
    sonet-torch serve      --run <dir> --port 8321              # HTTP daemon
    sonet-torch serve      --artifact <dir> --port 8321         # an export
    sonet-torch export     --run <dir> [--poly_batch]           # artifact
    sonet-torch prep       {sample,som,check,ingest} ...        # data prep

Each command runs ``sonet_torch.tasks.<name>.main(argv)`` (``prep``:
``sonet_torch.data.prep.main``), so
``sonet-torch <command> --help`` shows that command's flags; every
command takes ``--device {cuda,cpu}`` (default ``cuda``).  Modules load
only when a command runs: listing the commands imports no torch.
"""

from __future__ import annotations

import sys

# subcommand -> (module path, one-line help)
_COMMANDS = {
    "classify": ("sonet_torch.tasks.classify",
                 "train classification (ModelNet40/10, SHREC16, MNIST)"),
    "partseg": ("sonet_torch.tasks.partseg",
                "train part segmentation (ShapeNetPart)"),
    "segment": ("sonet_torch.tasks.partseg", "alias of partseg"),
    "autoencode": ("sonet_torch.tasks.autoencode",
                   "train the point-cloud autoencoder (Chamfer)"),
    "retrieve": ("sonet_torch.tasks.retrieve",
                 "rank SHREC16 retrieval (rank files, mAP/P@k)"),
    "reproduce": ("sonet_torch.tasks.reproduce",
                  "archive -> ingest -> som -> check -> train -> gated "
                  "verdict, one command"),
    "infer": ("sonet_torch.tasks.infer",
              "restore a run and stream a split (predictions + metrics)"),
    "serve": ("sonet_torch.tasks.serve",
              "HTTP model server (JSON/npz predict API)"),
    "export": ("sonet_torch.tasks.export",
               "export a run to a torch.export serving artifact"),
    "prep": ("sonet_torch.data.prep",
             "dataset preparation (sample meshes, fit SOMs, check trees)"),
}


def _usage() -> str:
    lines = ["usage: sonet-torch <command> [flags]   (sonet-torch <command> "
             "--help for that command's flags)", "", "commands:"]
    for name, (_, help_line) in _COMMANDS.items():
        lines.append(f"  {name:<12} {help_line}")
    return "\n".join(lines)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"sonet-torch: unknown command {cmd!r}\n\n{_usage()}",
              file=sys.stderr)
        return 2
    import importlib

    result = importlib.import_module(_COMMANDS[cmd][0]).main(rest)
    # a driver returns its metrics for programmatic callers; as a process
    # exit code that means success (bool is an int: True is not code 1)
    if isinstance(result, int) and not isinstance(result, bool):
        return result
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
