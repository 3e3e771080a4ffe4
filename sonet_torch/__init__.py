"""sonet_torch — SO-Net in PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU.

The port of the JAX package that sits beside it in this repository.
Module names mirror the JAX package (``config``, ``ops``, ``nn``,
``models``, ``serving``, ``train``, ``som``, ``data``, ``retrieval``,
``utils``, ``tasks``, ``cli``) so each module's counterpart is easy to
find; the JAX package's Pallas kernels become CUDA C++ sources under
``csrc/``, built with ``nvcc`` at first use (``ops/cuda``).

Layout convention: channel-last ``(B, N, C)`` at every public function,
as in the JAX package, so the two can be compared like with like.

Entry points (``models.build_model``, ``serving.ServingEngine``,
``train.init_state``, ``train.Trainer``, ``som.fit``,
``data.SyntheticDataset``, the task drivers' ``--device``) run on ``cuda``
unless the caller asks for ``cpu``; asking for ``cuda`` on a host without
a card raises instead of falling back.
"""

__version__ = "0.1.0"

# subpackages import lazily on attribute access, as in the JAX package
_LAZY = ("config", "device", "ops", "nn", "models", "convert", "compat",
         "serving", "train", "som", "data", "retrieval", "utils", "tasks",
         "cli", "parallel")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_LAZY, "__version__"]
