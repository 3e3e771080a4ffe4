"""Where a profiled forward or step spends its device time, by kernel
name (counterpart of the JAX package's ``utils/hlocat.py``).

The JAX package's profiler names ops ``fusion.N``, so its ``hlocat``
joins them with the compiled HLO text (``parse_hlo_fusions``) to say what
each fusion does.  The port runs no XLA: there is no HLO, and nothing to
join.  Its trace names every kernel by its own symbol (cuBLAS and
CUTLASS GEMMs, PyTorch's elementwise, reduction and sort templates, the
port's CUDA kernels), so the buckets come from the names alone, and
``parse_hlo_fusions`` has no counterpart.  The module keeps the JAX
package's name so that a reader finds it.

``categorize`` takes ``utils.tprof.device_time``'s {name: ms} and gives
ms by bucket; ``bucket`` names the bucket of one kernel.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Tuple

# (bucket, pattern), the first match wins
_BUCKETS = (
    # kernel 1's and kernel 2's own symbols (sonet_torch/csrc/)
    ("pooling kernel", re.compile(
        r"\b(segment_max_window_(bulk|direct)|fill_empty|"
        r"segment_argmax_keys|clear_keys|unpack_keys)\b")),
    ("copies and memsets", re.compile(
        r"^(Memcpy|Memset)|direct_copy_kernel|CatArrayBatchedCopy")),
    # Adam's update: csrc/adam_step.cu on a card (torch.optim.Adam's
    # foreach multi-tensor kernels where it runs)
    ("Adam", re.compile(r"[Aa]dam|multi_tensor_apply_kernel")),
    # the stable sort of the points and its helpers (not searchsorted)
    ("sorts", re.compile(r"(?<!search)[Ss]ort|fill_index_and_segment")),
    # cuBLAS (nvjet, the sm80 FFMA xmma kernels), CUTLASS
    ("GEMMs", re.compile(
        r"gemm|Gemm|GEMM|gemv|cutlass|nvjet|xmma|cublas|splitKreduce")),
    # gathers, scatters (scatter_add's ReduceAdd too) and index kernels
    ("other", re.compile(r"scatter|gather|[Ii]ndex")),
    ("BatchNorm statistics and other reductions", re.compile(
        r"reduce_kernel|[Rr]educ|welford|[Nn]orm|cumsum")),
    ("elementwise", re.compile(r"elementwise")),
)
OTHER = "other"


def bucket(name: str) -> str:
    """The bucket of one kernel, copy or memset name."""
    for label, pattern in _BUCKETS:
        if pattern.search(name):
            return label
    return OTHER


def named_ops(per_op: Dict[str, float]) -> List[Tuple[float, str]]:
    """[(ms, name)] of the rows that took time, the largest first."""
    return sorted(((ms, name) for name, ms in per_op.items() if ms > 0),
                  reverse=True)


def categorize(per_op: Dict[str, float]) -> Dict[str, float]:
    """{bucket: ms} of a ``device_time`` {kernel name: ms} dict."""
    cats: Dict[str, float] = collections.Counter()
    for ms, name in named_ops(per_op):
        cats[bucket(name)] += ms
    return dict(cats)
