"""Device selection for the port's entry points."""

from __future__ import annotations

import math

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``.  Asking for ``cuda`` on a host without a card raises; the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def refuse_mesh(mesh, work: str) -> None:
    """Raise ``NotImplementedError`` when ``mesh`` asks for more than one
    device: ``mesh`` is a shape, a device count or the command line's text
    ('4,2', '4x2', '8'; text that is no shape exits), and None, 0 or ''
    for none.  ``work`` says what the port does on one device ("trains",
    "infers", ...)."""
    if not mesh:
        return
    if isinstance(mesh, str):
        from .config import parse_mesh_shape
        try:
            mesh = parse_mesh_shape(mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh_shape: {e}")
    shape = tuple(mesh) if isinstance(mesh, (tuple, list)) else (mesh,)
    if math.prod(shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {shape}: the port {work} on one device; meshes are "
            f"ROADMAP.md §1 item 12")
