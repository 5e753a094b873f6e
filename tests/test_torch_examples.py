"""PyTorch port, the six examples' twins (``examples/torch_*.py``) on the
CPU at their smoke sizes, each through its ``main([... "--device",
"cpu"])``, against what its twin in ``examples/`` shows:

* ``torch_quickstart``: the class norms of exact routing within 1e-5 of
  the reference's ``capsnet.forward`` on the same weights (carried across
  by ``convert.capsnet_to_jax``) and images; approximate routing keeps the
  classification; the planner's picks are the reference's; the cuda
  backend (its plain versions here) agrees with the torch backend; the
  early-exit work counter does the full grid at ε = 0 and less above;
* ``torch_distributed_routing`` on two gloo ranks: the B, L and H
  shardings (torch and cuda backends), the 2D plan, ``plan="auto"`` and
  EM's L sharding equal the unsharded result within the sharded gate
  (rtol 2e-4, atol 2e-5), each sharding issuing collectives;
* ``torch_serve_capsnet``: every request completed, pipelined scores equal
  the unpipelined ones within 1e-5, the async invariant;
* ``torch_train_capsnet``: a run of 6 steps, then a resume at step 6 that
  trains steps 7-12 (checkpoints step-indexed), finite losses;
* ``torch_serve_lm``: tokens of (batch, gen) for a dense and a Mamba
  smoke config, decode deterministic;
* ``torch_train_lm``: the loss falls over 20 steps, and a second run
  resumes at step 20.
"""
import importlib
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.caps_benchmarks import CAPS_BENCHMARKS as J_CAPS
from repro.configs.caps_benchmarks import smoke_caps as j_smoke_caps
from repro.core import distribution as jD
from repro.models import capsnet as jcapsnet
from repro_torch import convert
from repro_torch.configs.caps_benchmarks import smoke_caps
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.models.capsnet import CapsNet

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
CPU = ["--device", "cpu"]
FWD_ATOL = 1e-5
SHARDED = dict(rtol=2e-4, atol=2e-5)     # the sharded routing gate


def _example(name):
    if EXAMPLES not in sys.path:      # spawned ranks inherit sys.path
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def test_quickstart_twin_matches_the_reference():
    res = _example("torch_quickstart").main(CPU)
    cfg = smoke_caps()
    net = CapsNet(cfg, device="cpu", seed=0)
    images = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                                  cfg.num_h_caps).batch(0, 8)["images"]
    want = jcapsnet.forward(convert.capsnet_to_jax(net),
                            jnp.asarray(images), j_smoke_caps())
    np.testing.assert_allclose(res["class_probs"].numpy(),
                               np.asarray(want["class_probs"]),
                               atol=FWD_ATOL, rtol=FWD_ATOL)
    assert res["approx"]["same_classification"]
    s = jD.RPShape.from_caps_config(J_CAPS["Caps-MN1"])
    hmc = res["planner"]["HMC 32 vaults (paper Table 4)"]
    assert hmc["pick"] == jD.plan(s, jD.DeviceModel.hmc())
    assert hmc["scores"] == pytest.approx(
        dict(jD.score_table(s, jD.DeviceModel.hmc())), rel=1e-6)
    for plan in res["planner"].values():
        assert plan["auto_axes"] in ((), ((plan["pick"], "vault"),))
    assert res["kernel"]["backend_err"] <= FWD_ATOL
    assert res["kernel"]["kernel_vs_plain"] == 0.0       # the plain version
    assert res["kernel"]["launches"] == 0
    work, full = res["deep_edge"]["work"], res["deep_edge"]["full"]
    assert work[0.0] == full and work[1e6] < full


def test_distributed_routing_twin_on_two_cpu_ranks():
    res = _example("torch_distributed_routing").main(
        ["-n", "2", *CPU, "--timeout", "120"])
    assert res["ranks"] == 2
    bound = SHARDED["atol"] + SHARDED["rtol"]      # |v| < 1 (squashed)
    for dim in ("B", "L", "H"):
        for backend in ("torch", "cuda"):
            r = res[f"{dim}_{backend}"]
            assert r["err"] <= bound, (dim, backend, r)
            assert "all-reduce" in r["collectives"]
    assert res["BxL"]["err"] <= bound
    assert res["auto"]["axes"] == ((res["auto"]["pick"], "vault"),)
    assert res["auto"]["err"] <= bound
    for backend in ("torch", "cuda"):
        r = res[f"EM_L_{backend}"]
        assert max(r["pose_err"], r["act_err"]) <= 1e-4


def test_serve_capsnet_twin():
    res = _example("torch_serve_capsnet").main(CPU)
    assert res["ragged"]["completed"] == 16
    assert res["pipelined_gap"] <= 1e-5
    assert res["auto_gap"] <= 1e-4
    a = res["async"]
    assert a["submitted"] == 12 == a["completed"] + a["shed"]


def test_train_capsnet_twin_resumes_step_indexed(tmp_path):
    train = _example("torch_train_capsnet").main
    ckpt = ["--ckpt-dir", str(tmp_path)]
    first = train(["--smoke", "--steps", "6", *ckpt, *CPU])
    assert first["start"] == 0 and sorted(first["losses"]) == list(
        range(1, 7))
    again = train(["--smoke", "--routing", "fused", *ckpt, *CPU])
    assert again["start"] == 6 and sorted(again["losses"]) == list(
        range(7, 13))
    assert all(math.isfinite(x) for run in (first, again)
               for x in run["losses"].values())
    assert 0.0 <= again["eval_accuracy"] <= 1.0


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b"])
def test_serve_lm_twin(arch):
    res = _example("torch_serve_lm").main(["--arch", arch, "--gen", "8",
                                           *CPU])
    assert res["tokens"].shape == (4, 8) and res["deterministic"]


def test_train_lm_twin_loss_falls_and_resumes(tmp_path):
    train = _example("torch_train_lm").main
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "10"]
    first = train(["--steps", "20", *ckpt, *CPU])
    assert first["start"] == 0 and first["fell"]
    again = train(["--steps", "24", *ckpt, *CPU])
    assert again["start"] == 20 and sorted(again["losses"]) == [21, 22, 23,
                                                                 24]
