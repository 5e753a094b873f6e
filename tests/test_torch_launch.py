"""PyTorch port, multi-rank launch (``repro_torch.launch.ranks``,
``launch.mesh``) and the CLIs on several CPU gloo ranks:

* the launcher on 2 and 4 ranks: each rank's rank, world and an
  all-reduce; a rank that raises surfaces with its traceback while the
  others wait in a collective, without a hang; a rank that hangs is
  terminated at the run's wall limit; the CLI's exit codes;
* ``serve`` on 2 ranks at ``--requests 5, 6, 7 --batch 4 --gen 4`` for
  granite-3-2b, qwen3-moe-30b-a3b and mixtral-8x7b (prompt 40) smoke:
  every rank holds every request, token for token the 1-rank run's; on 3
  ranks, which ``--batch 4`` does not split over, the same; alone, it
  starts a rank a card only when ``--device`` names no card;
* ``train --mesh 2,2`` run alone starts four ranks, its losses within
  5e-7 of the 1-rank run's, and its checkpoint resumes onto ``--mesh 1,2``
  (two ranks), continuing the 1-rank run's losses;
* ``serve_caps --pipeline two_stage --smoke`` on 2 and 3 ranks (the third
  left out of the (2, 1) mesh), sync and ``--async``: the books balance,
  every rank of the mesh ran every wave, and the sync run's predictions
  equal ``--pipeline none``'s;
* ``make_smoke_mesh`` on 8 ranks: the shape, the axis names and the ranks'
  order equal the reference's ``make_smoke_mesh`` (read in a subprocess
  with 16 host devices, as tests/test_sharded.py reads its meshes), and a
  production mesh is refused on 8 ranks.

The launched functions live in this module, which imports no JAX, so that
each spawned rank imports it cheaply.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as tmesh
from repro_torch.launch import ranks
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_caps as tserve_caps
from repro_torch.launch import train as ttrain

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ATOL = 5e-7


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def _everyone(value):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def _probe(argv):
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    return _everyone((dist.get_rank(), dist.get_world_size(), float(t),
                      dist.get_backend(), torch.get_num_threads()))


def _raise_on_rank_1(argv):
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()          # the other ranks wait for rank 1 here


def _hang_on_rank_1(argv):
    if dist.get_rank() == 1:
        time.sleep(600)     # hangs outside any collective


def _serve_cases(argv):
    """``serve.main`` on each argv of the JSON list ``argv[0]``; every
    rank's tokens of each."""
    return [_everyone(np.stack(tserve.main(a)["results"]).tolist())
            for a in json.loads(argv[0])]


def _serve_caps_cases(argv):
    return [tserve_caps.main(a) for a in json.loads(argv[0])]


def _smoke_mesh(argv):
    m = tmesh.make_smoke_mesh(device=CPU)
    try:
        tmesh.make_production_mesh(device=CPU)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"ranks": m.mesh.tolist(), "axes": list(m.mesh_dim_names),
            "coords": _everyone(list(m.get_coordinate())),
            "refused": refused}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
def test_launcher_starts_joined_ranks(world):
    every = ranks.run(_probe, [], world, CPU)
    total = world * (world + 1) / 2
    assert [r[:4] for r in every] == [(r, world, total, "gloo")
                                      for r in range(world)]
    assert ranks.backend(world, CPU) == "gloo"


def test_a_raising_rank_surfaces_without_a_hang():
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankFailed,
                       match=r"(?s)rank 1 of 2 failed.*ValueError: rank one"):
        ranks.run(_raise_on_rank_1, [], 2, CPU)
    assert time.perf_counter() - t0 < 120


def test_a_rank_past_the_wall_limit_is_terminated():
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankFailed,
                       match=r"ranks \[.*1\] of 2 still running after 20 s"):
        ranks.run(_hang_on_rank_1, [], 2, CPU, timeout_s=20)
    assert time.perf_counter() - t0 < 90


def test_launcher_cli_exit_codes(capfd):
    assert ranks.main(["-n", "2", "repro_torch.launch.serve", "--smoke",
                       "--requests", "3", "--batch", "2", "--gen", "2",
                       "--device", CPU]) == 0
    assert capfd.readouterr().out.count("served 3 requests (6 tokens)") == 2
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ranks", "-n", "2",
         "repro_torch.launch.train", "--smoke", "--mesh", "2,2", "--device",
         CPU], capture_output=True, text=True, timeout=300, env=env)
    assert bad.returncode == 1
    assert "holds 4 ranks; the process group has 2" in bad.stderr


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,prompt", [("granite-3-2b", 16),
                                         ("qwen3-moe-30b-a3b", 16),
                                         ("mixtral-8x7b", 40)])
def test_serve_on_two_ranks_equals_one(arch, prompt):
    cases = [["--arch", arch, "--smoke", "--requests", str(n), "--batch",
              "4", "--gen", "4", "--prompt-len", str(prompt), "--device",
              CPU] for n in (5, 6, 7)]
    got = ranks.run(_serve_cases, [json.dumps(cases)], 2, CPU)
    for argv, every in zip(cases, got):
        want = np.stack(tserve.main(argv)["results"])
        assert want.shape == (int(argv[4]), 4)
        for tokens in every:        # rank 0's and rank 1's
            np.testing.assert_array_equal(np.array(tokens), want)


def test_serve_on_ranks_that_do_not_split_the_batch_equals_one():
    cases = [["--arch", arch, "--smoke", "--requests", "6", "--batch", "4",
              "--gen", "4", "--device", CPU]
             for arch in ("granite-3-2b", "qwen3-moe-30b-a3b")]
    got = ranks.run(_serve_cases, [json.dumps(cases)], 3, CPU)
    for argv, every in zip(cases, got):
        want = np.stack(tserve.main(argv)["results"])
        assert want.shape == (6, 4) and len(every) == 3
        for tokens in every:
            np.testing.assert_array_equal(np.array(tokens), want)


def test_serve_alone_starts_a_rank_a_card_only_for_an_unindexed_card(
        monkeypatch):
    launched = []

    class NoModel(Exception):
        pass

    def no_model(*a, **k):
        raise NoModel

    # alone: no process group, even where an earlier test left one
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(ranks, "run",
                        lambda main, argv, world, device, **k:
                        launched.append((argv, world, str(device))))
    monkeypatch.setattr(tserve.lm, "init_params", no_model)
    tserve.main(["--smoke", "--device", "cuda"])
    assert launched == [(["--smoke", "--device", "cuda"], 2, "cuda")]
    with pytest.raises(NoModel):        # served here, on card 1 alone
        tserve.main(["--smoke", "--device", "cuda:1"])
    assert len(launched) == 1


def test_train_mesh_alone_starts_its_ranks_and_resumes(tmp_path):
    base = ["--smoke", "--device", CPU]
    d = str(tmp_path / "ckpt")
    one = ttrain.main(base + ["--steps", "5"])["losses"]
    four = ttrain.main(base + ["--steps", "3", "--mesh", "2,2",
                               "--ckpt-dir", d])
    assert four["start"] == 0
    np.testing.assert_allclose(four["losses"], one[:3], rtol=0,
                               atol=TRAIN_ATOL)
    two = ttrain.main(base + ["--steps", "5", "--mesh", "1,2",
                              "--ckpt-dir", d])
    assert two["start"] == 3 and len(two["losses"]) == 2
    np.testing.assert_allclose(two["losses"], one[3:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", (2, 3))
def test_serve_caps_two_stage_on_ranks(world):
    base = ["--smoke", "--device", CPU, "--pipeline", "two_stage"]
    sync, asyn = ranks.run(_serve_caps_cases,
                           [json.dumps([base, base + ["--async"]])], world,
                           CPU)
    for s in (sync, asyn):
        assert s["completed"] == 24 and s["failed"] == 0
        assert s["submitted"] == s["completed"] + s["shed"] + s["failed"]
        # both pipe ranks ran every wave; with three ranks the third is
        # outside the (2, 1) mesh and only listened
        assert s["rank_waves"] == [s["waves"]] * 2 + [0] * (world - 2)
    want = tserve_caps.main(["--smoke", "--device", CPU, "--pipeline",
                             "none"])
    assert sync["predictions"] == want["predictions"]
    assert len(asyn["predictions"]) == 24


def test_smoke_mesh_on_eight_ranks_equals_the_reference():
    got = ranks.run(_smoke_mesh, [], 8, CPU)
    code = ("import json\n"
            "from repro.launch import mesh\n"
            "out = {}\n"
            "for mp in (False, True):\n"
            "    m = mesh.make_smoke_mesh(multi_pod=mp)\n"
            "    out[str(mp)] = [list(m.devices.shape), list(m.axis_names),\n"
            "                    [d.id for d in m.devices.flat]]\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=16",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    shape, axes, ids = ref["False"]
    assert np.array(got["ranks"]).shape == tuple(shape)
    assert got["axes"] == axes
    assert np.array(got["ranks"]).flatten().tolist() == ids
    assert got["coords"] == [list(np.unravel_index(r, shape))
                             for r in range(8)]
    for multi_pod in (False, True):
        assert tmesh.SMOKE[multi_pod] == (tuple(ref[str(multi_pod)][0]),
                                          tuple(ref[str(multi_pod)][1]))
    assert tmesh.PRODUCTION[False][0] == (16, 16)
    assert tmesh.PRODUCTION[True] == ((2, 16, 16), ("pod", "data", "model"))
    assert "holds 256 ranks; the process group has 8" in got["refused"]
