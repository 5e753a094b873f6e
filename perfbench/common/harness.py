"""What the benchmark finds by name, and what one run hands around.

Everything that belongs to one configuration, one cell or one per-layer
metric lives in a file of its own under the benchmark's folder:

    configs/<config>.json      the configuration as it is run
    workloads/<cell>.json      the cell: config, traffic, the kind and
                               its parameters, chips, why
    traffic/<kind>.py          the traffic module of that kind
    metrics/<metric>.py        the reader of one per-layer metric

``BENCHMARK.json`` at the root names them; nothing here lists them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class BenchError(RuntimeError):
    """The benchmark's own files disagree, or a run cannot be made."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A traffic module or reader file, imported by its path under a private
    name (its file name may hold dots and dashes)."""
    if not path.is_file():
        raise BenchError(f"no such file: {path}")
    key = "perfbench_file_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell as ``BENCHMARK.json`` and its own files give it."""
    name: str
    entry: dict                 # the cell's entry in BENCHMARK.json
    workload: dict              # workloads/<cell>.json
    config: dict                # configs/<config>.json
    traffic: ModuleType         # traffic/<kind>.py
    end_to_end: List[dict]      # the metrics this cell reports untraced
    per_layer: List[dict]       # ... and traced


def metric_in_cell(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(bench: dict, name: str, base: Path = BASE) -> Cell:
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise BenchError(f"BENCHMARK.json has {len(entries)} cells named "
                         f"{name!r}")
    entry = entries[0]
    workload = load_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry[key]:
            raise BenchError(f"workloads/{name}.json gives {key} "
                             f"{workload.get(key)!r}; BENCHMARK.json "
                             f"{entry[key]!r}")
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(configs) != 1:
        raise BenchError(f"no configuration {entry['config']!r}")
    config = load_json(base.parent / configs[0]["file"])
    traffic = load_module(base / "traffic" / f"{workload['kind']}.py")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if metric_in_cell(m, name, names)]
    return Cell(name, entry, workload, config, traffic, e2e, layer)


def load_reader(metric: dict, base: Path = BASE) -> ModuleType:
    mod = load_module(base / "metrics" / f"{metric['name']}.py")
    unit = getattr(mod, "UNIT", None)
    if unit != metric["unit"]:
        raise BenchError(f"metrics/{metric['name']}.py reads {unit!r}; "
                         f"BENCHMARK.json says {metric['unit']!r}")
    return mod


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of a run (weights, images, arrivals,
    samples), so the streams never share numbers."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@dataclasses.dataclass
class Check:
    """One number the run compares, beside its limit: the run is correct
    only where every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a traffic module hands back: its end-to-end metrics (host clock), the
    counters the readers read, the requests attempted and failed, and the
    comparisons with the reference."""
    e2e: Dict[str, float]
    counters: Dict[str, Any]
    attempted: int
    failed: int
    checks: List[Check]


@dataclasses.dataclass
class RunView:
    """What a per-layer reader gets."""
    cell: dict
    config: dict
    counters: Dict[str, Any]
    trace: Any                 # common.trace.Trace, or None
    peaks: Optional[dict]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclasses.dataclass
class RunContext:
    """One run of one cell, as its traffic module sees it.  The module calls
    ``setup_done()`` when set-up ends and the window begins, and
    ``window_closed()`` when the window's last result is on the host,
    before it frees the program's state and compares with the
    reference."""
    cell: Cell
    seed: int
    seconds: float
    device: Any                   # torch.device
    tracer: Any                   # common.trace.Tracer
    clock: Any
    t_start: float
    control: bool = False         # also read the control (calibration only)
    setup_s: Optional[float] = None
    memory_peak_bytes: Optional[int] = None
    control_checks: List[Check] = dataclasses.field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.cell.workload["params"]

    @property
    def config(self) -> dict:
        return self.cell.config

    def setup_done(self) -> None:
        self.setup_s = self.clock() - self.t_start

    def window_closed(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        else:
            self.memory_peak_bytes = 0
