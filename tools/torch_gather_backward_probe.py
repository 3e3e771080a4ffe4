#!/usr/bin/env python3
"""Time and check the ways to write ``gather_by_segment``'s backward on one
NVIDIA GPU, at the part segmenter's shapes.

    python3 tools/torch_gather_backward_probe.py

The backward sums a (B, kN, C) bf16 cotangent into (B, M, C): each node's
rows, about kN / M of them.  For the three node maps the segmenter gathers
(C = 384, 512, 1024 at B=8, kN=3072, M=64, node-sorted ids from a real
top-k assignment) it reads, by CUDA events (median of 30 runs of 20 calls):

* ``onehot_bmm_f32``  -- the transposed one-hot product in float32, one
  cast at the end (what ``sonet_torch.ops.gather`` runs when it is handed
  the one-hot);
* ``index_add_f32``   -- a float32 ``index_add_`` over the flattened rows,
  one cast at the end (what it runs without a one-hot);
* ``onehot_bmm_bf16`` -- the same product with bf16 operands and a bf16
  result, whose accumulation is the library's choice;
* ``scatter_add_bf16`` -- what autograd gives ``torch.gather``: a bf16
  ``scatter_add`` with atomics;
* ``package``         -- ``gather_by_segment``'s own backward through
  autograd, forward excluded,

and each one's error against the float64 sum rounded to bf16 once: the
share of entries that differ, and the largest difference in units of the
entry's bf16 spacing and as a share of the largest entry.  Every form runs
twice to see whether two runs agree bit for bit (atomics need not).  The
last line is a JSON object of all readings.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def time_ms(torch, fn, reps=30, inner=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("this probe runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from sonet_torch.ops import assign_topk, gather_by_segment, one_hot

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, k, M = 8, 1024, 3, 64
    pc = torch.randn(B, N, 3, generator=gen, device=dev)
    pick = torch.randperm(N, generator=gen, device=dev)[:M]
    ids = torch.sort(assign_topk(pc, pc[:, pick], k).min_idx,
                     dim=1).values.contiguous()                 # (8, 3072)
    kN = ids.shape[1]
    onehot = one_hot(ids, M, torch.bfloat16)                    # (B, kN, M)
    onehot_t32 = onehot.float().transpose(1, 2)
    rows = (ids.long() + M * torch.arange(B, device=dev)[:, None]).reshape(-1)
    out = {"card": card, "shape": [B, kN, M], "cases": []}

    for C in (384, 512, 1024):
        g = torch.randn(B, kN, C, generator=gen, device=dev).to(torch.bfloat16)
        idx = ids.long()[..., None].expand(B, kN, C)
        exact = torch.zeros(B * M, C, dtype=torch.float64, device=dev)
        exact.index_add_(0, rows, g.reshape(-1, C).double())
        once = exact.view(B, M, C).to(torch.bfloat16)
        scale = float(once.float().abs().max())

        table = torch.zeros(B, M, C, dtype=torch.bfloat16, device=dev,
                            requires_grad=True)
        gathered = gather_by_segment(table, ids, onehot)

        def package():
            return torch.autograd.grad(gathered, table, g,
                                       retain_graph=True)[0]

        def index_add_f32():
            acc = torch.zeros(B * M, C, dtype=torch.float32, device=dev)
            acc.index_add_(0, rows, g.reshape(-1, C).float())
            return acc.view(B, M, C).to(torch.bfloat16)

        forms = {
            "onehot_bmm_f32": lambda: torch.bmm(onehot_t32, g.float()).to(
                torch.bfloat16),
            "index_add_f32": index_add_f32,
            "onehot_bmm_bf16": lambda: torch.bmm(onehot.transpose(1, 2), g),
            "scatter_add_bf16": lambda: torch.zeros(
                B, M, C, dtype=torch.bfloat16, device=dev).scatter_add_(
                1, idx, g),
            "package": package,
        }
        for name, fn in forms.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            diff = (got.float() - once.float()).abs()
            # the spacing of bf16 (8 bits of mantissa) around the larger of
            # the two entries: a sum that cancels to nearly nothing has a
            # spacing far below its summands' rounding
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
                got.float().abs(), once.float().abs()).clamp_min(1e-30))) - 7)
            case = {"C": C, "form": name, "ms": time_ms(torch, fn),
                    "share_differing": float((got != once).float().mean()),
                    "max_diff_ulp": float((diff / ulp).max()),
                    "max_diff_of_largest": float(diff.max()) / scale,
                    "two_runs_equal": bool(torch.equal(got, again))}
            out["cases"].append(case)
            print(f"C={C:5d} {name:17s} {case['ms']:.4f} ms; differs from "
                  f"the float64 sum rounded once on "
                  f"{case['share_differing']:.4%} of entries, by at most "
                  f"{case['max_diff_ulp']:.2f} bf16 spacings and "
                  f"{case['max_diff_of_largest']:.3%} of the largest entry; "
                  f"two runs equal: {case['two_runs_equal']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
