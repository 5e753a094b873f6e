"""PyTorch port, MoE training and expert parallelism against the JAX
package on the same numpy inputs, with the reference's weights carried
across by ``convert.lm_params_from_jax``:

* ``forward_train``'s logits and its aux (the sum over layers of each MoE
  block's Switch load-balance term), ``loss_fn`` and its parts (ce,
  moe_aux, tokens) and whole-tree gradients against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` on the qwen3-moe-30b-a3b
  and mixtral-8x7b smoke configs in fp32 (``FWD_ATOL`` 1e-5,
  ``GRAD_ATOL`` 1e-4), remat on and off — remat adds no aux twice;
* the aux's gradient flows through the mean router probability only;
* the loss falls over five steps, which report ``moe_aux``; the train CLI
  with ``--smoke`` for both MoE archs and a ``--layers`` cut;
* ``_moe_local`` on a slice of the expert slots (``expert_offset``)
  against the reference's, shard by shard; the "E"-sharded Router on a
  1-rank gloo mesh in-process and on two gloo ranks in a subprocess
  (``FileStore`` in tmp_path, no network) against the unsharded port and
  the reference's per-shard partials; a differentiable E-sharded plan
  and ``moe_forward(rules=...)`` on one rank equal the unsharded ones.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import checkpoint as tck
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
from repro_torch.data import synthetic as tsynthetic
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import train_loop as ttrain

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
# mixtral's prompt crosses its 32-token window; the reference's attention
# chunk must divide it
SEQ = {"qwen3-moe-30b-a3b": 12, "mixtral-8x7b": 48}
B = 2


def _close(got, want, tol, err_msg=""):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(arch, remat=False):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "remat": remat, "attn_chunk": 16})
    tcfg = type(tcfg)(**{**tcfg.__dict__, "remat": remat})
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference params as numpy): the reference's smoke weights,
    carried across afresh by each test (the step updates in place)."""
    arch = request.param
    jcfg, _ = _configs(arch)
    return arch, jax.tree.map(np.asarray,
                              jlm.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, seq, index=0):
    b = tsynthetic.SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq).batch(
        index, B)
    b["labels"][0, :3] = -1     # labels < 0 are masked out of the loss
    return b


# ---------------------------------------------------------------------------
# forward_train, loss_fn and gradients
# ---------------------------------------------------------------------------

def test_forward_train_logits_and_aux_match_reference(model):
    arch, params_np = model
    jcfg, tcfg = _configs(arch)
    batch = _batch(tcfg, SEQ[arch])
    jlogits, jaux = jlm.forward_train(jax.tree.map(jnp.asarray, params_np),
                                      jcfg, {"tokens": batch["tokens"]})
    tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
    with torch.no_grad():
        logits, aux = tlm.forward_train(tparams, tcfg,
                                        {"tokens": batch["tokens"]})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=FWD_ATOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= FWD_ATOL
    # the sum over layers: each block's term is about top_k when balanced
    assert tcfg.n_layers * 0.5 < float(aux) < tcfg.n_layers * 2 * \
        tcfg.moe.top_k


@pytest.mark.parametrize("remat", [False, True])
def test_loss_parts_and_whole_tree_gradients_vs_reference(model, remat):
    arch, params_np = model
    jcfg, tcfg = _configs(arch, remat)
    batch = _batch(tcfg, SEQ[arch])
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                           has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), batch)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(tparams).items()}
    loss, metrics = tlm.loss_fn(tparams, tcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss, jloss, FWD_ATOL)
    for k in ("ce", "moe_aux"):
        _close(metrics[k], jmetrics[k], FWD_ATOL, k)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) \
        == B * SEQ[arch] - 3
    _close(loss, (metrics["ce"] + 0.01 * metrics["moe_aux"]).detach(),
           FWD_ATOL)
    want = _flat_jax(jgrads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        _close(g, want[k], GRAD_ATOL, k)


def test_remat_adds_the_aux_once_and_keeps_the_gradients():
    arch = "mixtral-8x7b"
    jcfg, _ = _configs(arch)
    params_np = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(1)))
    out = {}
    for remat in (False, True):
        _, tcfg = _configs(arch, remat)
        tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
        leaves = {k: p.requires_grad_(True)
                  for k, p in tck.flatten(tparams).items()}
        loss, metrics = tlm.loss_fn(tparams, tcfg, _batch(tcfg, 48))
        out[remat] = (metrics["moe_aux"].detach(), torch.autograd.grad(
            loss, list(leaves.values())))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_aux_gradient_flows_through_the_router_probabilities_only():
    """d aux / d router_w equals the gradient of E·Σ mean(probs)·f with the
    token fractions f held constant, as in the reference."""
    cfg = tmoe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2)
    params = tmoe.init_moe(torch.Generator().manual_seed(3), cfg,
                           dtype=torch.float32, device=CPU)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 20, 16)).astype(np.float32))
    w = params["router"].clone().requires_grad_(True)
    _, aux = tmoe.moe_forward({**params, "router": w}, x, cfg)
    (g,) = torch.autograd.grad(aux, w)
    probs = torch.softmax(x[0] @ w, -1)
    ids = tmoe._top_k(probs.detach(), 2)[1]
    frac = torch.nn.functional.one_hot(ids, 4).float().sum(1).mean(0)
    (want,) = torch.autograd.grad(4 * (probs.mean(0) * frac).sum(), w)
    torch.testing.assert_close(g, want)


# ---------------------------------------------------------------------------
# training steps and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_falls_and_steps_report_the_aux(arch):
    _, tcfg = _configs(arch)
    params, opt = ttrain.init_train_state(tcfg, device=CPU)
    step = ttrain.make_train_step(tcfg, opt_cfg=AdamWConfig(lr=1e-3),
                                  warmup=1, total_steps=100)
    batch = _batch(tcfg, SEQ[arch])
    losses = []
    for _ in range(5):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["moe_aux"])) and float(m["moe_aux"]) > 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.05, losses


@pytest.mark.parametrize("argv", [
    ["--arch", "mixtral-8x7b", "--smoke", "--steps", "3"],
    ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "3"],
    ["--arch", "mixtral-8x7b", "--smoke", "--steps", "2", "--layers", "1",
     "--seq", "40", "--global-batch", "4", "--microbatches", "2"]])
def test_train_cli_trains_the_moe_family(argv, capsys):
    out = ttrain_cli.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "moe_aux" in text and "done" in text
    assert len(out["losses"]) == out["steps"] and all(
        np.isfinite(out["losses"]))
    if "--layers" in argv:
        assert "layers=1" in text
        assert out["params"]["layers"]["attn"]["wq"].shape[0] == 1
    with pytest.raises(ValueError, match="--layers"):
        ttrain_cli.main(["--arch", "mixtral-8x7b", "--smoke", "--layers",
                         "3", "--device", "cpu"])


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def _moe_case(sub_experts=1, T=40, seed=0):
    cfg = dict(d_model=16, d_ff=32, n_experts=8, top_k=2,
               capacity_factor=1.0, sub_experts=sub_experts)
    jcfg = jmoe.MoEConfig(**cfg)
    jparams = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    x = np.random.default_rng(seed).standard_normal((T, 16)).astype(
        np.float32)
    return jcfg, jparams, tmoe.MoEConfig(**cfg), x


@pytest.mark.parametrize("sub_experts,shards", [(1, 2), (1, 4), (2, 2),
                                                (2, 8)])
def test_moe_local_on_a_slice_of_slots_matches_reference(sub_experts,
                                                         shards):
    jcfg, jp, tcfg, x = _moe_case(sub_experts)
    args = [jp[k] for k in ("w_gate", "w_up", "w_down")]
    e_loc = jcfg.n_shards_experts // shards
    total = np.zeros_like(x)
    for r in range(shards):
        sl = slice(r * e_loc, (r + 1) * e_loc)
        want, want_aux = jmoe._moe_local(
            jnp.asarray(x), jnp.asarray(jp["router"]),
            *(jnp.asarray(a[sl]) for a in args), jcfg, r * e_loc, None)
        got, aux = tmoe._moe_local(
            torch.from_numpy(x), torch.from_numpy(jp["router"]),
            *(torch.from_numpy(a[sl]) for a in args), tcfg, r * e_loc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_ATOL, rtol=0)
        assert abs(float(aux) - float(want_aux)) <= FWD_ATOL
        total += got.numpy()
    full, _ = tmoe._moe_local(torch.from_numpy(x),
                              torch.from_numpy(jp["router"]),
                              *(torch.from_numpy(a) for a in args), tcfg)
    np.testing.assert_allclose(total, full.numpy(), atol=FWD_ATOL, rtol=0)


def test_e_sharded_router_on_one_rank_and_the_raises():
    jcfg, jp, tcfg, x = _moe_case(sub_experts=2)
    mesh = mesh_utils.make_mesh((1,), ("x",), device=CPU)
    spec = RouterSpec(algorithm="moe", options=(("moe_cfg", tcfg),))
    args = (torch.from_numpy(x), *(torch.from_numpy(jp[k]) for k in (
        "router", "w_gate", "w_up", "w_down")))
    y, aux = build_router(spec, ExecutionPlan(mesh=mesh, axes=(("E", "x"),)),
                          device=CPU)(*args)
    y0, aux0 = build_router(spec, device=CPU)(*args)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    # a differentiable E-sharded plan (slice 8) and moe_forward under
    # sharding rules (slice 11) run: gradients and outputs equal the
    # unsharded ones on one rank
    grads = []
    for plan in (ExecutionPlan(mesh=mesh, axes=(("E", "x"),)), None):
        ins = [a.clone().requires_grad_(True) for a in args]
        y, aux = build_router(spec._replace(differentiable=True), plan,
                              device=CPU)(*ins)
        grads.append(torch.autograd.grad(y.sum() + aux, ins))
    for g, g0 in zip(*grads):
        torch.testing.assert_close(g, g0, rtol=0, atol=1e-6)
    rules = tL.AxisRules({"batch": "data", "experts": "model"},
                         mesh_utils.make_mesh((1, 1), ("data", "model"),
                                              device=CPU))
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      device=CPU)
    with torch.no_grad():
        xb = torch.from_numpy(x).reshape(2, -1, 16)
        got = tmoe.moe_forward(p, xb, tcfg, rules=rules)
        want = tmoe.moe_forward(p, xb, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_RANKS = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, d):
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), 2), rank=rank, world_size=2)
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.models.moe import MoEConfig
    from repro_torch.runtime import mesh_utils
    inp = np.load(os.path.join(d, "inputs.npz"))
    cfg = MoEConfig(*[float(v) if i == 4 else int(v)
                      for i, v in enumerate(inp["cfg"])])
    mesh = mesh_utils.make_mesh((2,), ("expert",), device="cpu")
    spec = RouterSpec(algorithm="moe", options=(("moe_cfg", cfg),))
    router = build_router(spec, ExecutionPlan(mesh=mesh,
                                              axes=(("E", "expert"),)),
                          device="cpu")
    y, aux = router(*(torch.from_numpy(inp[k]) for k in (
        "x", "router", "w_gate", "w_up", "w_down")))
    np.savez(os.path.join(d, f"rank{rank}.npz"), y=y.numpy(),
             aux=aux.numpy())
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(sys.argv[1],), nprocs=2)
'''


@pytest.mark.parametrize("sub_experts", [1, 2])
def test_e_sharded_router_on_two_gloo_ranks(tmp_path, sub_experts):
    jcfg, jp, tcfg, x = _moe_case(sub_experts, T=64, seed=2)
    np.savez(tmp_path / "inputs.npz", x=x, cfg=np.array(tuple(tcfg),
                                                        np.float64), **jp)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in ("y", "aux"):                     # replicated on both ranks
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    args = [jp[k] for k in ("router", "w_gate", "w_up", "w_down")]
    y, aux = tmoe._moe_local(torch.from_numpy(x),
                             *(torch.from_numpy(a) for a in args), tcfg)
    scale = max(1.0, float(y.abs().max()))
    np.testing.assert_allclose(ranks[0]["y"], y.numpy(),
                               atol=FWD_ATOL * scale, rtol=0)
    assert float(ranks[0]["aux"]) == float(aux)
    e_loc = jcfg.n_shards_experts // 2
    want = sum(np.asarray(jmoe._moe_local(
        jnp.asarray(x), jnp.asarray(jp["router"]),
        *(jnp.asarray(a[r * e_loc:(r + 1) * e_loc]) for a in args[1:]),
        jcfg, r * e_loc, None)[0]) for r in range(2))
    np.testing.assert_allclose(ranks[0]["y"], want, atol=FWD_ATOL * scale,
                               rtol=0)
