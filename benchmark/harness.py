"""One run of one cell: the manifest, the files each cell is made of, the
run's context, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``benchmark/configs/<config>.json``: the configuration as it is run
  (``config``: every field of the program's ``Config``) and the split it
  trains or serves from (``split``);
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters,
  among them ``driver``;
* ``benchmark/drivers/<driver>.py``: the code that sets up and drives a
  window (``run(ctx) -> Result``);
* ``benchmark/limits/<cell>.json``: the limit of each number the
  comparison with the reference computes;
* ``benchmark/metrics/<metric>.py``: the reader of each per-layer metric
  (``read(readings) -> float | None``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# whole top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "optax", "sonet_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (found by name, not imported
    by package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise SystemExit(f"missing {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_for(manifest: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_for(manifest: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
    return out.stdout.strip().replace("\n", "; ")


def banned_modules() -> List[str]:
    """The banned top-level names among the loaded modules."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


class Spans:
    """The harness's own spans around its calls into the program, marked in
    a ``torch.profiler`` trace when one is recording (as
    ``bench:<name>``; ``trace.py`` reads them)."""

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function
        with record_function("bench:" + name):
            yield


@dataclasses.dataclass
class Result:
    """What a driver hands back.  ``end_to_end``: {metric: value} of this
    cell's end-to-end metrics; ``readings``: what the per-layer readers
    read; ``checks``: [(number, value, limit)] of the comparison with the
    reference; ``correct``: every number within its limit and every
    request or step answered."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: Dict[str, Any]
    checks: List[Tuple[str, float, float]]
    correct: bool
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


@dataclasses.dataclass
class Context:
    """One run: the cell, its files, the command line, and a phase
    printer."""
    manifest: dict
    cell: dict
    config_file: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    spans: Spans = dataclasses.field(default_factory=Spans)

    def cfg(self):
        """The program's ``Config`` for the configuration file."""
        from sonet_torch.config import Config
        fields = dict(self.config_file["config"])
        for k in ("mesh_shape", "mesh_axes"):
            fields[k] = tuple(fields[k])
        return Config(**fields)

    @property
    def cfg_dict(self) -> dict:
        return dict(self.config_file["config"])

    @contextlib.contextmanager
    def phase(self, name: str):
        """Print a set-up phase's seconds on its own line of stdout."""
        t0 = time.perf_counter()
        yield
        print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


def make_context(manifest: dict, cell_name: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float,
                 overrides: Optional[dict] = None) -> Context:
    """The context of one run of ``cell_name``.  ``overrides`` (tests
    only) replaces entries of the configuration file (``config``,
    ``split``), the traffic and the limits, key by key."""
    ov = overrides or {}
    cell = find(manifest["workloads"], cell_name, "workload")
    config_file = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    for part in ("config", "split"):
        config_file[part] = {**config_file[part], **ov.get(part, {})}
    traffic = {**load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
               **ov.get("traffic", {})}
    limits = {**load_json(BENCH_DIR / "limits" / f"{cell_name}.json"),
              **ov.get("limits", {})}
    return Context(manifest=manifest, cell=cell, config_file=config_file,
                   traffic=traffic, limits=limits, seed=int(seed),
                   seconds=float(seconds), trace=bool(trace), device=device,
                   t_start=t_start)


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """Each number the cell's limits name, beside its limit; correct when
    every one is a finite number within it.  A limit on a number the
    comparison does not compute is an error."""
    checks = []
    ok = True
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"a limit on {name!r}, which is not computed")
        value = float(numbers[name])
        checks.append((name, value, float(limit)))
        ok = ok and math.isfinite(value) and value <= float(limit)
    return ok, checks


def run_cell(ctx: Context) -> Result:
    """Run the cell's driver, then, in a traced run, its per-layer
    readers."""
    driver = load_module(BENCH_DIR / "drivers" / f"{ctx.traffic['driver']}.py",
                         f"bench_driver_{ctx.traffic['driver']}")
    result = driver.run(ctx)
    if ctx.trace:
        result.end_to_end = {}
        result.readings["per_layer"] = read_per_layer(ctx, result.readings)
    return result


def read_per_layer(ctx: Context, readings: dict) -> Dict[str, float]:
    """{metric: value} of the cell's per-layer metrics; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in per_layer_for(ctx.manifest, ctx.cell["name"]):
        mod = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def result_line(ctx: Context, result: Result, device: dict) -> dict:
    """The JSON object of the run's last line of stdout."""
    units = {m["name"]: m["unit"]
             for m in ctx.manifest["end_to_end"] + ctx.manifest["per_layer"]}
    if ctx.trace:
        values = result.readings["per_layer"]
    else:
        values = {m["name"]: result.end_to_end[m["name"]]
                  for m in end_to_end_for(ctx.manifest, ctx.cell["name"])}
    line = {"correct": bool(result.correct),
            "attempted": int(result.attempted),
            "failed": int(result.failed),
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device}
    if ctx.trace and result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in result.checks}
    return line
