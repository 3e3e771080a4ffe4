#!/usr/bin/env python3
"""Quality artifact of the PyTorch port (``sonet_torch``) for one preset;
counterpart of ``tools/quality.py``.

One command runs the committed band check for a preset on the card and
writes ``QUALITY_torch_<preset>.json`` at the repo root, so that a port
that computes each step right yet learns worse (BatchNorm statistics,
tie routing, the halving schedule, augmentation, epoch seeding) lands
the final eval metric outside the committed 3-seed band
(``tools/soak_bands.json``) and the artifact records it.

Chain (each stage skipped when its output already exists):

    1. generate the band's dataset at its committed hardness
       (tools/torch_make_<family>_scale.py --hardness H --seed 0, the
       generator and seed the band was measured on)
    2. fit SOM nodes on the card (python -m sonet_torch.data.prep som)
    3. band-asserted soak (tools/torch_soak.py --band, the band's epochs,
       device pipeline; shrec16: tools/torch_soak_retrieval.py --band)
    4. write the artifact: the keys of ``tools/quality.py``'s plus
       ``device`` (the card's name and power limit, as nvidia-smi gives
       them; "cpu" with ``--device cpu``) and ``package``

The soak's run directory (its config and metrics; with ``--save`` its
final checkpoint) goes beside the artifact, into
``<artifact without .json>_runs/``.

    python3 tools/torch_quality.py --preset modelnet40 \\
        [--dataroot DIR] [--out QUALITY_torch_modelnet40.json]

Exit 0 iff the metric landed inside the band.  Further ``--<Config
field> value`` pairs are passed to the soak and narrow the preset (the
CPU tests run the chain at a tiny width with ``--device cpu``).
"""

import argparse
import ast
import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# preset -> (generator script, default dataroot, som rows)
FAMILIES = {
    "modelnet40": ("torch_make_modelnet_scale.py", "/root/mn40_scale", 8),
    "shapenetpart": ("torch_make_shapenet_scale.py", "/root/snpart_scale", 8),
    "shrec16": ("torch_make_shrec_scale.py", "/root/shrec_scale", 8),
}


def _run(cmd, env=None):
    """Stream a child's output; return (rc, full stdout text)."""
    print(f"quality: $ {' '.join(cmd)}", flush=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    for line in proc.stdout:
        print(line, end="", flush=True)
        lines.append(line)
    proc.wait()
    return proc.returncode, "".join(lines)


def parse_soak_output(out: str, rc: int):
    """(value, inside, final_eval, clouds_per_sec) from a soak driver's
    stdout.  The band-check line is authoritative for value/inside; the
    soak's exit code is the fallback when the line is missing (the run
    died before its eval)."""
    inside = rc == 0
    value = None
    m = re.search(r"band check: (\S+) ([0-9.]+) (INSIDE|OUTSIDE)", out)
    if m:
        value = float(m.group(2))
        inside = m.group(3) == "INSIDE"
    ev = None
    em = re.search(r"^(?:eval|retrieval metrics[^:]*): (\{.*\})$", out,
                   re.M)
    if em:
        try:
            ev = {k: round(float(v), 4)
                  for k, v in ast.literal_eval(em.group(1)).items()
                  if isinstance(v, (int, float))}
        except (ValueError, SyntaxError):
            pass
    clouds = None
    cm = re.findall(r"= ([0-9.]+) clouds/s", out)
    if cm:
        clouds = float(cm[-1])
    return value, inside, ev, clouds


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"
    for a run on the CPU."""
    if device == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def need_som(preset: str, root: str, rows: int) -> bool:
    """True when the tree has no SOM nodes yet: ModelNet keeps them in
    ``<rows>x<rows>_som_nodes``; the npz layouts carry a ``som_node``
    key, which ``prep som`` writes into each file."""
    if preset == "modelnet40":
        return not os.path.isdir(os.path.join(root, f"{rows}x{rows}_som_nodes"))
    import numpy as np
    npzs = sorted(glob.glob(os.path.join(root, "**", "*.npz"),
                            recursive=True))
    if not npzs:
        return True
    with np.load(npzs[0]) as z:
        return "som_node" not in z.files


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="modelnet40",
                    choices=sorted(FAMILIES))
    ap.add_argument("--dataroot", default=None,
                    help="dataset tree (default per preset; generated "
                         "at the band's hardness when missing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="artifact path (default "
                         "<repo>/QUALITY_torch_<preset>.json)")
    args, rest = ap.parse_known_args(argv)

    with open(os.path.join(REPO, "tools", "soak_bands.json")) as f:
        band = json.load(f)[args.preset]
    gen, default_root, rows = FAMILIES[args.preset]
    root = args.dataroot or default_root
    out_path = args.out or os.path.join(
        REPO, f"QUALITY_torch_{args.preset}.json")
    runs = os.path.splitext(out_path)[0] + "_runs"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")

    t0 = time.time()
    # ---- 1. dataset (generator + committed hardness + seed 0) ----------
    marker = {"modelnet40": "modelnet40_train.txt",
              "shapenetpart": "train_test_split",
              "shrec16": "train.txt"}[args.preset]
    if not os.path.exists(os.path.join(root, marker)):
        rc, _ = _run([sys.executable, os.path.join(REPO, "tools", gen),
                      "--out", root, "--hardness", str(band["hardness"]),
                      "--seed", "0"], env=env)
        if rc:
            sys.exit(f"quality: dataset generation failed ({rc})")
    else:
        print(f"quality: reusing dataset {root}", flush=True)
    t1 = time.time()

    # ---- 2. SOM nodes (prep som on the card; npz layouts rewrite) ------
    if need_som(args.preset, root, rows):
        rc, _ = _run([sys.executable, "-m", "sonet_torch.data.prep", "som",
                      "--root", root, "--rows", str(rows), "--batch", "64",
                      "--device", args.device], env=env)
        if rc:
            sys.exit(f"quality: SOM fitting failed ({rc})")
    else:
        print("quality: SOM nodes already present", flush=True)
    t2 = time.time()

    # ---- 3. band-asserted soak ------------------------------------------
    # shrec16's committed band is a retrieval band (test mAP over rank
    # files), measured by the retrieval soak: torch_soak.py would hold
    # classification accuracy against it instead
    if args.preset == "shrec16":
        cmd = [sys.executable,
               os.path.join(REPO, "tools", "torch_soak_retrieval.py"),
               "--dataroot", root, "--epochs", str(band["epochs"]),
               "--seed", str(args.seed), "--band"]
    else:
        cmd = [sys.executable, os.path.join(REPO, "tools", "torch_soak.py"),
               "--preset", args.preset, "--dataroot", root,
               "--epochs", str(band["epochs"]),
               "--input_pipeline", "device",
               "--seed", str(args.seed), "--band"]
    rc, out = _run(cmd + ["--out", runs, "--device", args.device] + rest,
                   env=env)
    value, inside, ev, clouds = parse_soak_output(out, rc)
    t3 = time.time()
    print(f"quality: generate {t1 - t0:.1f} s, prep som {t2 - t1:.1f} s, "
          f"soak {t3 - t2:.1f} s (host clock)", flush=True)

    # ---- 4. artifact -----------------------------------------------------
    artifact = {
        "quality": args.preset,
        "metric": band["metric"],
        "value": value,
        "band": [band["lo"], band["hi"]],
        "inside": bool(inside),
        "hardness": band["hardness"],
        "epochs": band["epochs"],
        "seed": args.seed,
        "dataset": band["dataset"],
        "band_seeds": band["seeds"],
        "final_eval": ev,
        "sustained_clouds_per_sec": clouds,
        "wall_s": round(time.time() - t0, 1),
        "soak_rc": rc,
        "device": card(args.device),
        "package": "sonet_torch",
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    print(json.dumps({k: artifact[k] for k in
                      ("quality", "metric", "value", "band", "inside")}),
          flush=True)
    return 0 if inside else 1


if __name__ == "__main__":
    raise SystemExit(main())
