"""A copy of the benchmark's folder with CPU-sized cells beside the real
ones, for the tests: the smoke configuration is Caps-MN1's structure at
a quarter of its capsules and a quarter of its conv channels."""
from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

import torch

from perfbench.common import harness, runner

SMOKE_CONFIG = {
    "name": "caps-smoke", "source": "test", "network": "Caps-smoke",
    "dataset": "synthetic", "model": "CapsNet", "dtype": "float32",
    "routing": "dynamic", "batch_size": 16, "num_l_caps": 288,
    "num_h_caps": 10, "routing_iters": 3, "l_caps_dim": 8, "h_caps_dim": 16,
    "image_hw": 28, "image_channels": 1, "conv_channels": 64,
    "conv_kernel": 9, "caps_channels": 8, "caps_kernel": 9, "caps_stride": 2,
    "decoder_hidden": [512, 1024], "recon_weight": 0.0005,
    "digit_w_std": 0.05,
}

SMOKE_PARAMS = {
    "batch": {"microbatch": 16, "n_micro": 2, "pool_waves": 2,
              "warmup_waves": 1, "sample_waves": 2},
    "train": {"pool_batches": 4},
}


def make_base(tmp: Path) -> Path:
    """``tmp/perfbench``: the benchmark's folder, its BENCHMARK.json, and a
    smoke cell ``caps-smoke.<traffic>`` beside each real cell."""
    src = harness.BASE
    base = tmp / "perfbench"
    shutil.copytree(src, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (base / "configs" / "caps-smoke.json").write_text(
        json.dumps(SMOKE_CONFIG))
    bench["configs"].append({"name": "caps-smoke", "source": "test",
                             "file": "perfbench/configs/caps-smoke.json",
                             "reduced": []})
    for entry in list(bench["workloads"]):
        if entry["config"] != "caps-mn1":
            continue
        w = harness.load_json(base / "workloads" / f"{entry['name']}.json")
        name = "caps-smoke." + w["traffic"]
        w = copy.deepcopy(w)
        w.update(name=name, config="caps-smoke")
        w["params"].update(SMOKE_PARAMS[w["kind"]])
        (base / "workloads" / f"{name}.json").write_text(json.dumps(w))
        bench["workloads"].append(dict(entry, name=name, config="caps-smoke"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if entry["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


def run_cell(base: Path, name: str, seed: int = 5, seconds: float = 1.0,
             traced: bool = False, control: bool = False):
    """One run of a cell on the CPU, past the harness's look for a card.
    Returns (result line, context, outcome)."""
    bench = harness.load_json(base.parent / "BENCHMARK.json")
    cell = harness.load_cell(bench, name, base)
    ctx, outcome, readers = runner.execute(
        cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
        time.perf_counter, control=control, base=base)
    return runner.result(ctx, outcome, readers, "cpu", 1), ctx, outcome
