"""Offline dataset preparation CLI (port of the JAX package's
``data/prep.py``): the replacement for the whole reference preprocessing
world, Matlab mesh sampling (data/sampler_matlab/) and the SOM-building
notebook (data/build_som/save_som.ipynb).

    sonet-torch prep {sample,som,check,ingest} ...

Subcommands:

* ``sample``  — .obj meshes -> per-shape npz {pc, sn} (area-weighted,
  10k points like sampler.m).
* ``som``     — batch-fit SOMs for per-shape npy/npz clouds on the device
  (``--device``, ``cuda`` unless ``cpu`` is asked for) and write them in
  the layouts the loaders expect:
  ModelNet: ``<root>/<rows>x<cols>_som_nodes/<class>/<name>.npy``;
  npz datasets: adds a ``som_node`` key next to {pc, sn, ...}.
* ``check``   — validate a prepared tree against a loader layout
  (split lists, file existence, array shapes/finiteness) BEFORE
  training instead of crashing mid-epoch in a loader worker.
* ``ingest``  — unpack a published prepared-dataset archive
  (reference README.md:45-49) into a validated dataroot: locates the
  layout root inside the archive, records the sha256 in
  ``<dest>/ingest.json`` and finishes with ``check`` (VERDICT r2 #7;
  walkthrough in MIGRATING.md §2).

The SOM fit samples ``--som_sample`` points per shape (4096, matching
save_som.ipynb cell 1), stacks shapes into batches of ``--batch`` and runs
``sonet_torch.som.fit`` on each; the points are drawn as the JAX package
draws them (the same bytes for the same seed), and the last batch is
padded with copies of its last cloud as it pads it (each cloud's fit is
its own, so the copies change no node).  The file layouts and the
``check`` and ``ingest`` reports are the JAX package's.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List

import numpy as np


def _iter_cloud_files(root: str) -> List[str]:
    files = []
    for ext in ("npy", "npz"):
        files += glob.glob(os.path.join(root, "**", f"*.{ext}"),
                           recursive=True)
    return sorted(f for f in files if "_som_nodes" not in f)


def _load_cloud(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["pc"]
    data = np.load(path)
    return data[:, 0:3] if data.ndim == 2 and data.shape[1] >= 3 else data


def cmd_som(args) -> None:
    from ..config import Config
    from ..parallel import is_main
    from ..parallel.distributed import all_gather
    from ..parallel.mesh import block, setup_mesh
    from ..som import SOMConfig, fit as som_fit

    # --mesh_shape D: the fits are independent per cloud, so each of D
    # processes fits its block of every batch; process 0 writes the nodes
    want = (max(args.mesh_shape, 1), 1)
    _, mesh, dev = setup_mesh(Config(mesh_shape=want, batch_size=args.batch,
                                     distributed=args.distributed),
                              args.device)
    main_rank = is_main()
    files = _iter_cloud_files(args.root)
    if not files:
        print(f"no .npy/.npz clouds under {args.root}", file=sys.stderr)
        sys.exit(1)
    rows = args.rows
    cfg = SOMConfig(rows=rows, cols=rows, dim=3, schedule=args.schedule)
    rng = np.random.default_rng(args.seed)

    batch, paths = [], []

    def flush():
        if not batch:
            return
        # pad a final partial batch to full size, as the JAX package does
        # (zip(paths, nodes) below drops the padded rows)
        while len(batch) < args.batch:
            batch.append(batch[-1])
        mine = block(np.stack(batch), ("data",), mesh)
        nodes = all_gather(som_fit(mine, cfg, device=dev), ("data",), mesh)
        for p, node in zip(paths, nodes.cpu().numpy()):
            if main_rank:
                _write_som(args.root, p,
                           np.ascontiguousarray(node, np.float32), rows)
        batch.clear()
        paths.clear()

    for path in files:
        pc = _load_cloud(path).astype(np.float32)
        n = min(args.som_sample, len(pc))
        idx = rng.choice(len(pc), args.som_sample, replace=n < args.som_sample)
        batch.append(pc[idx])
        paths.append(path)
        if len(batch) == args.batch:
            flush()
    flush()
    if main_rank:
        print(f"fitted {rows}x{rows} SOMs for {len(files)} shapes")


def _write_som(root: str, cloud_path: str, node: np.ndarray,
               rows: int) -> None:
    if cloud_path.endswith(".npz"):
        data = dict(np.load(cloud_path))
        data["som_node"] = node
        np.savez(cloud_path, **data)
    else:
        rel = os.path.relpath(cloud_path, root)
        out = os.path.join(root, f"{rows}x{rows}_som_nodes", rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.save(out, node)


def cmd_sample(args) -> None:
    from .sampler import normalize_cloud, read_obj, sample_mesh

    objs = sorted(glob.glob(os.path.join(args.root, "**", "*.obj"),
                            recursive=True))
    if not objs:
        print(f"no .obj meshes under {args.root}", file=sys.stderr)
        sys.exit(1)
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    for path in objs:
        v, f = read_obj(path)
        pts, normals = sample_mesh(v, f, args.points, rng)
        if args.normalize:
            pts = normalize_cloud(pts)
        rel = os.path.splitext(os.path.relpath(path, args.root))[0]
        out = os.path.join(args.out, rel + ".npz")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez(out, pc=pts, sn=normals)
    print(f"sampled {len(objs)} meshes -> {args.out}")


def _finite(a: np.ndarray) -> bool:
    return bool(np.isfinite(a).all())


def cmd_check(args) -> None:
    """Validate a prepared dataset tree against a loader layout.

    The reference has no such tool — a wrong path/shape surfaces as a
    mid-training crash deep in a DataLoader worker.  Checks split lists,
    the existence of every referenced file, and (for ``--load`` sampled
    items per split) array shapes/dtypes/finiteness the loaders rely on.
    Exits nonzero and lists problems if anything is off."""
    import json as _json

    from ..config import Config

    rows = args.rows
    M = rows * rows
    problems: List[str] = []
    counts = {}
    loaded = 0

    def sample_idx(n: int) -> List[int]:
        if args.load == 0:  # existence-only pass
            return []
        if args.load < 0 or args.load >= n:
            return list(range(n))
        return sorted({int(i) for i in
                       np.linspace(0, n - 1, args.load)})

    def note_missing(paths, mode):
        missing = [q for q in paths if not os.path.exists(q)]
        problems.extend(f"missing: {q}" for q in missing[:20])
        if len(missing) > 20:
            problems.append(f"... {len(missing) - 20} more missing "
                            f"in {mode}")

    def check_cloud(path, arr, name, width=3, n_ref=None):
        nonlocal loaded
        loaded += 1
        if arr.ndim != 2 or arr.shape[1] < width:
            problems.append(f"{path}: {name} shape {arr.shape}, want "
                            f"(N, >={width})")
            return None
        if n_ref is not None and arr.shape[0] != n_ref:
            problems.append(f"{path}: {name} has {arr.shape[0]} rows, "
                            f"pc has {n_ref}")
        if arr.shape[0] < args.min_points:
            problems.append(f"{path}: only {arr.shape[0]} points "
                            f"(< --min_points {args.min_points})")
        if not _finite(arr):
            problems.append(f"{path}: {name} has non-finite values")
        return arr.shape[0]

    def check_som(path, node, where):
        if node.shape != (M, 3):
            problems.append(f"{where}: som_node shape {node.shape}, want "
                            f"({M}, 3) for --rows {rows}")
        elif not _finite(node):
            problems.append(f"{where}: som_node has non-finite values")

    if args.layout == "modelnet":
        from .modelnet import make_dataset_modelnet
        cfg = Config(classes=args.classes, node_num=M)
        for mode in ("train", "test"):
            try:
                items = make_dataset_modelnet(args.root, mode, cfg)
            except FileNotFoundError as e:
                counts[mode] = None  # split absent: note, not a failure
                print(f"  note: no {mode} split ({e})", file=sys.stderr)
                continue
            except (OSError, ValueError) as e:
                problems.append(f"{mode} split unreadable: {e}")
                continue
            counts[mode] = len(items)
            note_missing([p for it in items for p in (it[0], it[2])],
                         mode)
            for i in sample_idx(len(items)):
                pc_path, _, som_path = items[i]
                if not os.path.exists(pc_path) or not os.path.exists(som_path):
                    continue
                data = np.load(pc_path)
                check_cloud(pc_path, data, "pc+normal", width=6)
                check_som(som_path, np.load(som_path), som_path)
    elif args.layout == "shrec":
        from .modelnet import make_dataset_shrec2016
        cfg = Config(node_num=M)
        for mode in ("train", "val", "test"):
            try:
                items = make_dataset_shrec2016(args.root, mode, cfg)
            except FileNotFoundError as e:
                counts[mode] = None
                print(f"  note: no {mode} split ({e})", file=sys.stderr)
                continue
            except (OSError, ValueError) as e:
                problems.append(f"{mode} split unreadable: {e}")
                continue
            counts[mode] = len(items)
            note_missing([it[0] for it in items], mode)
            for i in sample_idx(len(items)):
                path = items[i][0]
                if not os.path.exists(path):
                    continue
                with np.load(path) as z:
                    keys = set(z.files)
                    if not {"pc", "sn", "som_node"} <= keys:
                        problems.append(f"{path}: npz keys {sorted(keys)}, "
                                        f"want pc/sn/som_node")
                        continue
                    n = check_cloud(path, z["pc"], "pc")
                    check_cloud(path, z["sn"], "sn", n_ref=n)
                    check_som(path, z["som_node"], path)
    elif args.layout == "shapenet":
        from .shapenet import FOLDERS, make_dataset_shapenet
        for mode in ("train", "test"):
            try:
                entries = make_dataset_shapenet(args.root, mode)
            except FileNotFoundError as e:
                counts[mode] = None
                print(f"  note: no {mode} split ({e})", file=sys.stderr)
                continue
            except (OSError, ValueError) as e:
                problems.append(f"{mode} split unreadable: {e}")
                continue
            counts[mode] = len(entries)
            paths = []
            for e in entries:
                file = e[11:]  # strip 'shape_data/' (shapenet.py)
                if file[0:8] not in FOLDERS:
                    problems.append(f"{mode}: unknown category folder in "
                                    f"split entry {e!r}")
                    continue
                paths.append(os.path.join(args.root,
                                          f"{file}_{rows}x{rows}.npz"))
            note_missing(paths, mode)
            for i in sample_idx(len(paths)):
                path = paths[i]
                if not os.path.exists(path):
                    continue
                with np.load(path) as z:
                    keys = set(z.files)
                    if not {"pc", "sn", "part_label", "som_node"} <= keys:
                        problems.append(f"{path}: npz keys {sorted(keys)}, "
                                        f"want pc/sn/part_label/som_node")
                        continue
                    n = check_cloud(path, z["pc"], "pc")
                    check_cloud(path, z["sn"], "sn", n_ref=n)
                    check_som(path, z["som_node"], path)
                    pl = z["part_label"]
                    if n is not None and pl.shape != (n,):
                        problems.append(f"{path}: part_label shape "
                                        f"{pl.shape}, want ({n},)")
                    elif pl.size and (pl.min() < 0 or pl.max() >= 50):
                        problems.append(f"{path}: part_label range "
                                        f"[{pl.min()}, {pl.max()}], want "
                                        f"[0, 50)")

    if not any(v is not None for v in counts.values()):
        # every split file was absent: almost always a wrong --root /
        # --layout / --classes — the one thing a validator must not
        # pass on (fail-closed)
        problems.append(f"no split lists found under {args.root} for "
                        f"layout {args.layout!r} (wrong --root, --layout "
                        f"or --classes?)")
    report = {"layout": args.layout, "root": args.root, "splits": counts,
              "items_loaded": loaded, "problems": len(problems),
              "ok": not problems}
    print(_json.dumps(report))
    for p in problems[:50]:
        print(f"  {p}", file=sys.stderr)
    if len(problems) > 50:
        print(f"  ... {len(problems) - 50} more", file=sys.stderr)
    if problems:
        sys.exit(1)


# --------------------------------------------------------------------------
# ingest: published prepared archives -> validated dataset trees
# --------------------------------------------------------------------------

_LAYOUT_MARKER = {
    # file whose presence identifies a layout root (the loaders' split
    # lists: modelnet.py:37-53, :56-80, shapenet.py:38-44)
    "modelnet": lambda d, a: os.path.exists(
        os.path.join(d, f"modelnet{a.classes}_shape_names.txt")),
    "shrec": lambda d, a: (os.path.exists(os.path.join(d, "category.txt"))
                           and os.path.exists(os.path.join(d, "train.txt"))),
    "shapenet": lambda d, a: os.path.exists(
        os.path.join(d, "train_test_split",
                     "shuffled_train_file_list.json")),
}


def _sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _extract_archive(archive: str, out_dir: str) -> None:
    """Safe extraction for .zip / .tar(.gz|.bz2|.xz) (path-traversal
    guarded; the stdlib default tar extraction is unsafe pre-3.14)."""
    import tarfile
    import zipfile

    if zipfile.is_zipfile(archive):
        with zipfile.ZipFile(archive) as z:
            base = os.path.realpath(out_dir)
            for info in z.infolist():
                target = os.path.realpath(os.path.join(out_dir,
                                                       info.filename))
                if not (target == base
                        or target.startswith(base + os.sep)):
                    raise ValueError(
                        f"archive member escapes the target dir: "
                        f"{info.filename!r}")
            z.extractall(out_dir)
        return
    if tarfile.is_tarfile(archive):
        with tarfile.open(archive) as t:
            t.extractall(out_dir, filter="data")
        return
    raise ValueError(f"{archive}: not a zip or tar archive (for other "
                     f"formats, extract manually and pass the directory)")


def _find_layout_root(tree: str, args) -> tuple:
    """(dir, layout) of the first directory that matches a layout marker
    (topdown walk: the shallowest match wins)."""
    layouts = ([args.layout] if args.layout
               else ["modelnet", "shrec", "shapenet"])
    for dirpath, dirnames, _ in os.walk(tree):
        dirnames.sort()
        for layout in layouts:
            if _LAYOUT_MARKER[layout](dirpath, args):
                return dirpath, layout
    raise FileNotFoundError(
        f"no {'/'.join(layouts)} layout root found in the archive "
        f"(looked for the loaders' split-list files; for modelnet the "
        f"marker is modelnet{args.classes}_shape_names.txt — pass "
        f"--classes to match the archive)")


def cmd_ingest(args) -> None:
    """Unpack a published prepared-dataset archive into a validated
    tree: the one-command path from the author's prepared downloads
    (reference README.md:45-49) to a train-ready --dataroot
    (VERDICT r2 #7).  Records the archive checksum in
    ``<dest>/ingest.json`` and finishes with ``prep check``."""
    import json as _json
    import shutil
    import tempfile

    src = args.archive
    dest = args.dest
    if os.path.exists(dest) and os.listdir(dest) and not args.force:
        print(f"{dest} exists and is not empty (pass --force to merge "
              f"into it)", file=sys.stderr)
        sys.exit(1)
    os.makedirs(dest, exist_ok=True)

    manifest = {"archive": os.path.abspath(src)}
    tmp = None
    try:
        if os.path.isdir(src):
            tree = src
            move = False  # never destroy a user-supplied directory
        else:
            manifest["sha256"] = _sha256(src)
            manifest["bytes"] = os.path.getsize(src)
            # extract next to dest: same filesystem -> moves are renames
            tmp = tempfile.mkdtemp(prefix=".ingest_",
                                   dir=os.path.dirname(os.path.abspath(
                                       dest)) or ".")
            print(f"extracting {src} ...", flush=True)
            _extract_archive(src, tmp)
            tree = tmp
            move = True

        root, layout = _find_layout_root(tree, args)
        manifest["layout"] = layout
        manifest["root_in_archive"] = os.path.relpath(root, tree)
        n_files = 0
        for entry in sorted(os.listdir(root)):
            s = os.path.join(root, entry)
            d = os.path.join(dest, entry)
            if move:
                shutil.move(s, d)
            elif os.path.isdir(s):
                shutil.copytree(s, d, dirs_exist_ok=args.force)
            else:
                shutil.copy2(s, d)
            n_files += 1
        manifest["entries"] = n_files
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    with open(os.path.join(dest, "ingest.json"), "w") as f:
        _json.dump(manifest, f, indent=2)
    print(_json.dumps({"ingested": dest, **{k: manifest[k] for k in
                                            ("layout", "entries")}}),
          flush=True)

    if not args.no_check:
        check = argparse.Namespace(
            root=dest, layout=manifest["layout"], rows=args.rows,
            classes=args.classes, load=args.load, min_points=1)
        cmd_check(check)  # exits nonzero on problems


def main(argv=None) -> None:
    from ..tasks import device_parser

    p = argparse.ArgumentParser(prog="sonet-torch prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sample", help="mesh -> point cloud npz")
    ps.add_argument("--root", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--points", type=int, default=10000)  # sampler.m default
    ps.add_argument("--normalize", action="store_true")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_sample)

    pm = sub.add_parser("som", help="batch-fit SOM nodes on device",
                        parents=[device_parser()])
    pm.add_argument("--root", required=True)
    pm.add_argument("--rows", type=int, default=8)
    pm.add_argument("--som_sample", type=int, default=4096)
    pm.add_argument("--batch", type=int, default=64)
    pm.add_argument("--mesh_shape", type=int, default=0,
                    help="shard the fit batch over N processes of a "
                         "--distributed run (0 = one process)")
    pm.add_argument("--distributed", default="",
                    help="'auto' (torchrun's environment) or "
                         "'HOST:PORT,NPROC,PID'")
    pm.add_argument("--schedule", default="prep",
                    choices=("prep", "online"))
    pm.add_argument("--seed", type=int, default=0)
    pm.set_defaults(fn=cmd_som)

    pi = sub.add_parser("ingest", help="unpack + validate a published "
                                       "prepared-dataset archive")
    pi.add_argument("--archive", required=True,
                    help=".zip/.tar(.gz) archive or a pre-extracted dir")
    pi.add_argument("--dest", required=True,
                    help="destination dataroot to create")
    pi.add_argument("--layout", default=None,
                    choices=("modelnet", "shrec", "shapenet"),
                    help="expected layout (default: auto-detect)")
    pi.add_argument("--rows", type=int, default=8)
    pi.add_argument("--classes", type=int, default=40)
    pi.add_argument("--load", type=int, default=16,
                    help="items to fully load per split in the final "
                         "check (-1 = all)")
    pi.add_argument("--force", action="store_true",
                    help="merge into a non-empty --dest")
    pi.add_argument("--no_check", action="store_true")
    pi.set_defaults(fn=cmd_ingest)

    pc = sub.add_parser("check", help="validate a prepared dataset tree")
    pc.add_argument("--root", required=True)
    pc.add_argument("--layout", required=True,
                    choices=("modelnet", "shrec", "shapenet"))
    pc.add_argument("--rows", type=int, default=8)
    pc.add_argument("--classes", type=int, default=40,
                    help="modelnet split-file prefix (modelnet only)")
    pc.add_argument("--load", type=int, default=16,
                    help="items to fully load per split (-1 = all; "
                         "existence is always checked for every file)")
    pc.add_argument("--min_points", type=int, default=1,
                    help="minimum raw points per shape")
    pc.set_defaults(fn=cmd_check)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
