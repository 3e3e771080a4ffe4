"""Observability utilities of the port (counterparts of the JAX package's
``utils``), exported lazily: importing this package loads neither torch
nor matplotlib."""

_EXPORTS = {
    "MetricLogger": ".logging",
    "StepTimer": ".logging",
    "HTMLGallery": ".visualize",
    "load_part_colors": ".visualize",
    "save_point_cloud_png": ".visualize",
    "save_seg_comparison": ".visualize",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)


def __dir__():
    return sorted(__all__)
