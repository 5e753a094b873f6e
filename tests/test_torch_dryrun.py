"""PyTorch port, the dry run (``launch/dryrun.py``, ``launch/
routing_dryrun.py``) against the JAX package's:

* the shape cells, ``cell_is_runnable`` (its verdict and reason) and
  ``input_specs`` (shapes and dtypes) for the ten architectures × four
  shapes × 1 and 8 microbatches, and the microbatch rule: the reference's
  ``TRAIN_MICROBATCHES`` and its mistral-large branch, read from its source
  by ``ast`` (importing ``repro.launch.dryrun`` would set ``XLA_FLAGS`` for
  every later subprocess of this worker);
* the reference's five smoke cells (``tests/test_sharded.py::
  test_smoke_dryrun_machinery``) on both smoke meshes: ``ok``, a peak, FLOPs
  and, on several ranks, collective bytes; the parameter bytes a device
  equal to the ``lm.local_shape`` sum; the training cells' FLOPs at least
  6·N_active·tokens / n_devices (N_active without the input embedding
  table: a gather, not a product);
* the analysis against a real run: granite-3-2b's smoke training step on
  four CPU gloo ranks of a (2, 2) mesh (``tests/_torch_ranks.py``), its
  collective bytes by kind and the flash-attention kernels' calls equal to
  the dry run's trace of the same cell;
* ``routing_dryrun`` for Caps-MN1 at batch 256 (the smallest that 32 and
  256 ranks both divide): the reference's cells and skip reasons, and the
  planner's picks ``D.plan`` / ``D.plan_multi`` with ``DeviceModel.h100``;
* the CLI: exit 0, one JSON a cell, a rerun ``[cached]``, exit 1 on a
  failing cell.

The fake process groups run in one subprocess (a module fixture): a
process holds one default group, and an earlier test in this worker may
hold one.
"""
import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.configs as rconfigs
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
from repro_torch.core import distribution as D
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SMOKE
from repro_torch.models import lm
from repro_torch.runtime import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
ARCHS = tuple(tconfigs.list_archs())
SHAPES = tuple(tconfigs.SHAPES)
# the reference's smoke cells (tests/test_sharded.py:224-233)
SMOKE_CELLS = (("granite-3-2b", "train_4k"),
               ("qwen3-moe-30b-a3b", "prefill_32k"),
               ("falcon-mamba-7b", "decode_32k"),
               ("zamba2-7b", "long_500k"),
               ("seamless-m4t-large-v2", "train_4k"))
RANK_CELL = dict(arch="granite-3-2b", batch=8, seq=64, mesh=(2, 2))


def test_shape_cells_and_runnable_cells_equal_the_references():
    assert tconfigs.SUBQUADRATIC == rconfigs.base.SUBQUADRATIC
    for name in SHAPES:
        t, r = tconfigs.SHAPES[name], rconfigs.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == \
            (r.name, r.seq_len, r.global_batch, r.kind)
    assert set(SHAPES) == set(rconfigs.SHAPES)
    assert set(ARCHS) == set(rconfigs.list_archs())
    for arch in ARCHS:
        for shape in SHAPES:
            assert tconfigs.cell_is_runnable(arch, shape) == \
                rconfigs.cell_is_runnable(arch, shape), (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch):
    tcfg, rcfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
    for shape in SHAPES:
        for n in (1, 8):
            got = tconfigs.input_specs(tcfg, tconfigs.SHAPES[shape], n)
            want = rconfigs.input_specs(rcfg, rconfigs.SHAPES[shape], n)
            assert list(got) == list(want), (shape, n)
            for k, (shp, dtype) in got.items():
                assert shp == tuple(want[k].shape), (shape, n, k)
                assert str(dtype).removeprefix("torch.") == \
                    np.dtype(want[k].dtype).name, (shape, n, k)


def _reference_microbatch_code():
    """The reference's TRAIN_MICROBATCHES and the statements of
    ``lower_cell`` that choose the microbatches, from its source."""
    tree = ast.parse(open(REF_DRYRUN).read())
    table = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.AnnAssign)
                 and getattr(n.target, "id", "") == "TRAIN_MICROBATCHES")
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "lower_cell")
    branch = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and "shape.kind == 'train'" in ast.unparse(n.test))
    body = []
    for stmt in branch.body:
        if "record[" in ast.unparse(stmt):
            break
        body.append(stmt)
    return table, ast.unparse(ast.Module(body=body, type_ignores=[]))


def test_microbatch_rule_is_the_references():
    table, code = _reference_microbatch_code()
    assert table == dryrun.TRAIN_MICROBATCHES
    assert "mistral-large-123b" in code and "n_micro = 16" in code
    for arch in ARCHS + ("an-unlisted-arch",):
        for batch in (256, 64):
            for dp, multi in ((16, False), (32, True), (2, False),
                              (4, True)):
                for smoke in (False, True):
                    env = {"arch": arch, "multi_pod": multi, "smoke": smoke,
                           "TRAIN_MICROBATCHES": table, "mesh": None,
                           "dp_size": lambda mesh, dp=dp: dp,
                           "shape": tconfigs.ShapeCell("c", 64, batch,
                                                       "train")}
                    exec(code, env)
                    assert dryrun.num_microbatches(
                        arch, batch, dp, multi, smoke) == env["n_micro"], \
                        (arch, batch, dp, multi, smoke)
    assert dryrun.num_microbatches("mistral-large-123b", 256, 16, False,
                                   False) == 16
    assert dryrun.num_microbatches("mistral-large-123b", 256, 32, True,
                                   False) == 8


_TRACES = r"""
import json, sys
from repro_torch import configs as C
from repro_torch.launch import dryrun, routing_dryrun
spec = json.loads(sys.argv[1])
out = {"smoke": {}}
for arch, shape in spec["smoke"]:
    for mp in (False, True):
        out["smoke"][f"{arch}|{shape}|{int(mp)}"] = dryrun.lower_cell(
            arch, shape, mp, smoke=True)
rc = spec["rank_cell"]
cfg = C.get_smoke_config(rc["arch"])
out["rank_cell"] = dryrun.trace_on_mesh(
    cfg, C.ShapeCell("rank_cell", rc["seq"], rc["batch"], "train"),
    rc["mesh"], ("data", "model"), 0)
out["routing"] = routing_dryrun.run_config("Caps-MN1", 256)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    spec = {"smoke": SMOKE_CELLS, "rank_cell": RANK_CELL}
    proc = subprocess.run(
        [sys.executable, "-c", _TRACES, json.dumps(spec)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


class _Mesh:
    """A ``DeviceMesh``'s axis names and sizes, without a process group."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)

    def size(self, i=None):
        return math.prod(self.shape) if i is None else self.shape[i]


def _blocks(nbytes: int) -> int:
    return -(-nbytes // 512) * 512


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_cells_trace_on_both_meshes(traces, arch, shape, multi):
    rec = traces["smoke"][f"{arch}|{shape}|{int(multi)}"]
    assert rec["status"] == "ok", rec.get("traceback")
    mesh_shape, axes = SMOKE[multi]
    assert rec["n_devices"] == math.prod(mesh_shape) > 1
    assert sorted(rec["ranks"]) == sorted({"0", str(rec["n_devices"] - 1)})
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert rec["ops"]["flops"] > 0
    assert rec["ops"]["collective_bytes"] > 0
    assert rec["fake_device"] == dryrun.fake_device()
    cfg = tconfigs.get_smoke_config(arch)
    mode = {"train": "train", "prefill": "prefill", "decode": "decode"}[
        tconfigs.SHAPES[shape].kind]
    rules = sharding.make_rules(
        cfg, _Mesh(mesh_shape, axes), mode,
        {"batch": None} if tconfigs.SHAPES[shape].global_batch
        < math.prod(n for n, a in zip(mesh_shape, axes) if a != "model")
        else None)
    shapes = flatten(lm.init_params(cfg, device="meta"))
    laxes = flatten(lm.param_logical_axes(cfg))
    params = sum(_blocks(math.prod(lm.local_shape(tuple(t.shape), laxes[k],
                                                  rules))
                         * t.element_size()) for k, t in shapes.items())
    if mode == "prefill":
        # the arguments: the parameters a device holds and its rows
        specs = tconfigs.input_specs(cfg, tconfigs.SHAPES[shape])
        rows = dryrun.local_rows(rules, tconfigs.SHAPES[shape].global_batch)
        inputs = sum(_blocks(rows * math.prod(s[1:]) * d.itemsize)
                     for s, d in specs.values())
        for r in rec["ranks"].values():
            assert r["memory"]["argument_bytes"] == params + inputs
    if mode == "train":
        # parameters, the two fp32 moments, the step counter and the rows
        for r in rec["ranks"].values():
            assert r["memory"]["argument_bytes"] > params
        n = cfg.param_count() - cfg.vocab_padded * cfg.d_model
        tokens = (tconfigs.SHAPES[shape].global_batch
                  * tconfigs.SHAPES[shape].seq_len)
        assert rec["ops"]["flops"] >= 6.0 * n * tokens / rec["n_devices"]
        assert set(rec["ops"]["kernel_calls"]) == {
            "flash_attention_fwd_lse", "flash_attention_bwd"}


def test_four_gloo_ranks_count_what_the_dry_run_counts(traces, tmp_path):
    np.savez(tmp_path / "step_analysis.npz", arch=RANK_CELL["arch"],
             batch=RANK_CELL["batch"], seq=RANK_CELL["seq"])
    (tmp_path / "cases.json").write_text(json.dumps([{
        "name": "step_analysis", "case": "step_analysis",
        "mesh": [list(RANK_CELL["mesh"]), ["data", "model"]], "world": 4}]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_ranks.py"),
         str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    real = dict(np.load(tmp_path / "step_analysis.out.npz"))
    dry = traces["rank_cell"]["ops"]
    assert list(real["kinds"]) == sorted(dry["collective_by_kind"])
    for kind, nbytes, calls in zip(real["kinds"], real["bytes"],
                                   real["calls"]):
        assert nbytes == pytest.approx(dry["collective_by_kind"][kind],
                                       rel=1e-12)
        assert calls == dry["collective_calls"][kind]
    assert dict(zip(real["kernels"], real["kernel_calls"].tolist())) == {
        k: v["calls"] for k, v in dry["kernels"].items()}


def test_routing_dryrun_cells_and_planner_picks(traces):
    out = traces["routing"]
    caps = CAPS_BENCHMARKS["Caps-MN1"]
    s = D.RPShape(n_b=256, n_l=caps.num_l_caps, n_h=caps.num_h_caps,
                  c_l=caps.l_caps_dim, c_h=caps.h_caps_dim,
                  iters=caps.routing_iters)
    cells = out["cells"]
    # the reference's cells: B and L divide by 32, H = 10 does not
    assert sorted(cells) == ["pod_B1d", "pod_BL2d", "vault32_B",
                             "vault32_H", "vault32_L"]
    assert cells["vault32_H"]["status"] == "skip"
    assert cells["vault32_H"]["reason"].startswith(
        "H-extent 10 % 32 != 0 (paper allows imbalanced snippets;")
    for tag in ("vault32_B", "vault32_L", "pod_B1d", "pod_BL2d"):
        c = cells[tag]
        assert c["status"] == "ok" and c["flops"] > 0 \
            and c["collective_bytes"] > 0 and c["peak_bytes"] > 0, tag
        assert set(c["terms"]) == {"compute_s", "memory_s", "collective_s"}
        # the stage kernels of sharded routing, three iterations
        assert c["kernel_calls"]["routing_stage_votes"] == 3, tag
    assert cells["vault32_L"]["kernel_calls"][
        "routing_stage_update_fold"] == 3
    assert out["paper_scale"]["planner_pick"] == D.plan(
        s, D.DeviceModel.h100(32))
    candidates = {"B1d": {"B": 256}, "BL2d": {"B": 16, "L": 16}}
    assert out["pod_scale"]["planner_pick"] == D.plan_multi(
        s, D.DeviceModel.h100(256), candidates)
    assert out["pod_scale"]["ring_M_model"] == {
        k: D.comm_M_ring(v, s) for k, v in candidates.items()}
    assert out["paper_scale"]["paper_M"] == {
        d: D.comm_M(d, s, 32) for d in D.DIMS}


def test_cli_writes_a_record_a_cell_caches_and_fails_loudly(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
           "--arch", "falcon-mamba-7b", "--shape", "decode_32k",
           "--multi-pod", "both", "--out", str(tmp_path)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120)
    assert first.returncode == 0, first.stdout + first.stderr
    files = sorted(os.listdir(tmp_path))
    assert files == ["falcon-mamba-7b__decode_32k__multi.json",
                     "falcon-mamba-7b__decode_32k__single.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["status"] == "ok" and "ops" in rec and "trace_s" in rec
    assert "done: ok=2 skip=0 fail=0" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120)
    assert again.returncode == 0
    assert again.stdout.count("[cached]") == 2
    bad = subprocess.run(cmd[:5] + ["an-unknown-arch"] + cmd[6:],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and "fail=2" in bad.stdout
