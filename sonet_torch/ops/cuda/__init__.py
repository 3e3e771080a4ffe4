"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes``.  Libraries go to ``sonet_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edit
rebuilds and an unchanged source is built once per checkout.  Nothing is
built or loaded when this module is imported.

Every wrapper under ``ops/cuda/`` reaches its kernels through the seam
below: ``launcher`` for a typed C function that is loaded at its first
call and whose ``cudaError`` is checked, ``DTYPE_CODE`` for the element
type a kernel is told, and ``same_device`` for the one-device rule of
every entry point and CUDA implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ptxas_log: dict[str, str] = {}

# the ``dtype`` argument of every kernel that takes float32 or bf16 data
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns name -> path
    of the shared library; raises with the compiler's output on failure."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    try:
        for n, out in targets.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{n}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            _ptxas_log[n] = log
            os.replace(tmp, out)
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return targets


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported for ``name`` in this process's
    build (registers, shared memory, spills); empty if it was prebuilt."""
    return _ptxas_log.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def launcher(source: str, symbol: str, argtypes, query: bool = False):
    """The C function ``symbol`` of ``csrc/<source>.cu`` as a Python
    callable: the library is built and loaded, and the function's
    ``argtypes`` and ``int`` result declared, at the first call.  A call
    returns the function's result; unless ``query`` is set, that result
    is a ``cudaError_t``, and a non-zero one raises ``RuntimeError``."""
    fn = None

    def launch(*args) -> int:
        nonlocal fn
        if fn is None:
            typed = getattr(load(source), symbol)
            typed.argtypes = list(argtypes)
            typed.restype = ctypes.c_int
            fn = typed
        result = fn(*args)
        if result != 0 and not query:
            raise RuntimeError(f"csrc/{source}.cu {symbol} failed: "
                               f"cudaError {result}")
        return result
    return launch


def same_device(op: str, **tensors) -> None:
    """Raises ``ValueError`` naming ``op`` and the devices unless every
    tensor given (None is skipped) is on one device, a CUDA device or the
    CPU.  The entry points call it for a mix with the CPU or ``meta``,
    which the dispatcher would hand to the plain or the fake version; the
    CUDA implementations call it for calls through ``torch.ops``."""
    devices = {name: t.device for name, t in tensors.items()
               if t is not None}
    kinds = set(devices.values())
    if len(kinds) > 1 or any(d.type not in ("cpu", "cuda") for d in kinds):
        where = ", ".join(f"{name} on {d}" for name, d in devices.items())
        raise ValueError(f"{op}: {where}; all must be on one CUDA device "
                         "(or all on the CPU)")
