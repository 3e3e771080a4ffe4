"""Native (C++) host components of the port, loaded with ctypes (the port's
own copy of the JAX package's ``native``; the C++ sources beside this file
are built from here).

* ``loader.cpp``: the host input pipeline's worker: file read, subsample
  and augmentation of a whole batch in C++ threads, with the interpreter
  lock released (ctypes releases it for the call), the counterpart of the
  reference's ``DataLoader(num_workers=8)`` processes
  (modelnet/train.py:25).  Python surface: ``data/native_loader.py``.
* ``segment_max.cpp``: a CPU segment max and argmax, an oracle for the
  node pooling.

The library is built with ``g++`` at first use into ``sonet_torch/_build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, and
written under a temporary name and moved into place, so processes that
build at once never load a half-written file.  Nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "segment_max.cpp", HERE / "loader.cpp")
BUILD_DIR = HERE.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsonet_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the shared library unless it is built; returns its path.
    Raises ``RuntimeError`` with the compiler's output when ``g++`` fails
    or is missing."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native loader: cannot run g++: {e}") from e
    try:
        if r.returncode != 0:
            raise RuntimeError(f"native loader: g++ failed (exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.segment_argmax_cpu.argtypes = [fp, ip, i64, i64, i64, i64,
                                           ip, fp]
        lib.segment_argmax_cpu.restype = None
        lib.segment_argmax_cpu_mt.argtypes = [fp, ip, i64, i64, i64, i64,
                                              ip, fp, i64]
        lib.segment_argmax_cpu_mt.restype = None
        cp = ctypes.POINTER(ctypes.c_char_p)
        up = ctypes.POINTER(ctypes.c_uint64)
        ci = ctypes.c_int
        lib.sonet_load_batch.argtypes = [cp, cp, i64, i64, i64, up, ci,
                                         ci, ci, ci, i64, fp, fp, fp]
        lib.sonet_load_batch.restype = ci
        lib.sonet_load_npz_batch.argtypes = [cp, i64, i64, i64, up, ci,
                                             ci, ci, ci, ci, i64,
                                             fp, fp, fp, ip]
        lib.sonet_load_npz_batch.restype = ci
        lib.sonet_loader_error.argtypes = []
        lib.sonet_loader_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _paths(paths) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _seeds(item_seeds, B: int) -> np.ndarray:
    seeds = np.ascontiguousarray(item_seeds, np.uint64)
    if seeds.shape != (B,):
        raise ValueError(f"item_seeds {seeds.shape}, want ({B},)")
    return seeds


def load_batch_native(pc_paths, som_paths, item_seeds: np.ndarray,
                      n_points: int, n_nodes: int, *,
                      augment: bool = False, rot_horizontal: bool = False,
                      rot_perturbation: bool = False,
                      translation_perturbation: bool = False,
                      num_threads: int = 4
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load, subsample and augment a batch of ModelNet-layout items.

    pc_paths: B paths to (N, >=3|6) f32 .npy; som_paths: B paths to
    (n_nodes, 3) f32 .npy; item_seeds: (B,) uint64, one seed per item.
    Returns (pc (B, n_points, 3), sn (B, n_points, 3), node (B, n_nodes,
    3)) float32.  Raises RuntimeError on a bad file."""
    lib = _load()
    B = len(pc_paths)
    seeds = _seeds(item_seeds, B)
    pc = np.empty((B, n_points, 3), np.float32)
    sn = np.empty((B, n_points, 3), np.float32)
    node = np.empty((B, n_nodes, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    cp = ctypes.POINTER(ctypes.c_char_p)
    rc = lib.sonet_load_batch(
        ctypes.cast(_paths(pc_paths), cp), ctypes.cast(_paths(som_paths), cp),
        B, n_points, n_nodes,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(augment), int(rot_horizontal), int(rot_perturbation),
        int(translation_perturbation), int(num_threads),
        pc.ctypes.data_as(fp), sn.ctypes.data_as(fp),
        node.ctypes.data_as(fp))
    if rc != 0:
        raise RuntimeError(
            f"native loader: {lib.sonet_loader_error().decode()}")
    return pc, sn, node


def load_npz_batch_native(paths, item_seeds: np.ndarray, n_points: int,
                          n_nodes: int, *, augment_mode: int = 0,
                          rot_horizontal: bool = False,
                          rot_perturbation: bool = False,
                          translation_perturbation: bool = False,
                          with_seg: bool = False, num_threads: int = 4):
    """Load, resample and augment a batch of npz-layout items (SHREC
    ``{pc, sn, som_node}``; ShapeNetPart adds ``part_label``).

    augment_mode: 0 none, 1 the ModelNet/SHREC stack, 2 ShapeNetPart's
    jitter and scale.  Returns (pc, sn, node[, seg]) with seg int32
    (B, n_points) when ``with_seg``.  Reads ``np.savez`` (stored) members
    only; a compressed archive raises with a message."""
    lib = _load()
    B = len(paths)
    seeds = _seeds(item_seeds, B)
    pc = np.empty((B, n_points, 3), np.float32)
    sn = np.empty((B, n_points, 3), np.float32)
    node = np.empty((B, n_nodes, 3), np.float32)
    seg = np.empty((B, n_points) if with_seg else (1, 1), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    rc = lib.sonet_load_npz_batch(
        ctypes.cast(_paths(paths), ctypes.POINTER(ctypes.c_char_p)),
        B, n_points, n_nodes,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(augment_mode), int(rot_horizontal), int(rot_perturbation),
        int(translation_perturbation), int(with_seg), int(num_threads),
        pc.ctypes.data_as(fp), sn.ctypes.data_as(fp),
        node.ctypes.data_as(fp), seg.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(
            f"native loader: {lib.sonet_loader_error().decode()}")
    if with_seg:
        return pc, sn, node, seg
    return pc, sn, node


def segment_argmax_native(data: np.ndarray, seg_ids: np.ndarray,
                          num_segments: int, num_threads: int = 1
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(values (B, M, C) f32, argmax (B, M, C) int32) of ``data`` (B, N, C)
    per node of ``seg_ids`` (B, N): the first maximum, empty nodes take
    index 0 and point 0's value."""
    lib = _load()
    data = np.ascontiguousarray(data, np.float32)
    seg_ids = np.ascontiguousarray(seg_ids, np.int32)
    B, N, C = data.shape
    M = num_segments
    out_idx = np.zeros((B, M, C), np.int32)
    out_val = np.zeros((B, M, C), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    args = (data.ctypes.data_as(fp), seg_ids.ctypes.data_as(ip),
            B, N, C, M, out_idx.ctypes.data_as(ip),
            out_val.ctypes.data_as(fp))
    if num_threads > 1:
        lib.segment_argmax_cpu_mt(*args, num_threads)
    else:
        lib.segment_argmax_cpu(*args)
    return out_val, out_idx


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False
