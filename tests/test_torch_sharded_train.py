"""PyTorch port, sharded training (slice 8) against the JAX package, with the
reference's weights carried across by ``convert.lm_params_from_jax``:

* ``lm.loss_fn`` under the train rules and its whole-tree gradients
  (finished by ``sharding.sync_grads``, gathered by ``gather_params``)
  against the reference's unsharded ``jax.value_and_grad`` within
  ``FWD_ATOL``/``GRAD_ATOL`` (fp32 1e-5 and 1e-4): granite-3-2b,
  mixtral-8x7b (its window crossed), zamba2-7b, seamless-m4t-large-v2 and
  phi3-medium-14b on the sequence-sharded plan, smoke configs, on a
  (data 2, model 2) mesh, and granite on (1, 4), where its 2 KV heads
  do not split over 4 ranks and ``wk``/``wv`` are gathered before use;
* one ``make_train_step`` step over two microbatches with int8
  compression against the reference's step;
* a run resumed from (2, 2) onto (1, 2) through
  ``elastic.resume_or_init``, continuing within the reference's +0.5 of
  the loss; its checkpoint read by the reference's loader;
* the train CLI with ``--mesh 1,1 --device cpu`` and a resume; a mesh
  larger than the caller's one rank starts its own ranks, and a mesh
  spec of one axis is refused;
* CapsNet's torch-backend routing under the {B}, {L} and {H} plans and EM
  routing under {B} and {L}: outputs and input gradients against
  ``jax.grad`` of the reference's unsharded routing.

Each case runs on a 1-rank gloo mesh in-process and on CPU gloo ranks in
one subprocess (``tests/_torch_ranks.py``: a ``FileStore`` in tmp_path,
``repro_torch`` alone); the reference's values come from this process.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jconfigs
from repro import checkpoint as jck
from repro.core import em_routing as jem
from repro.core.router import RouterSpec as JRouterSpec
from repro.core.router import build_router as jbuild_router
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.runtime import compression as jcompression
from repro.runtime import train_loop as jtrain
from repro_torch import checkpoint as tck
from repro_torch.launch import train as ttrain_cli
from repro_torch.runtime import mesh_utils

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_ATOL = 1e-5            # tests/_gradcheck.py, fp32
GRAD_ATOL = 1e-4
B = 4
SEQ = {"mixtral-8x7b": 64}          # crosses its 32-token window
LOSS_CASES = {               # name -> (arch, attention plan, mesh)
    "granite": ("granite-3-2b", None, (2, 2)),
    "granite_kv_gathered": ("granite-3-2b", None, (1, 4)),
    "mixtral": ("mixtral-8x7b", None, (2, 2)),
    "zamba2": ("zamba2-7b", None, (2, 2)),
    "seamless": ("seamless-m4t-large-v2", None, (2, 2)),
    "phi3_seq_tp": ("phi3-medium-14b", "seq_tp", (2, 2)),
}


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jcfg(arch, plan=None):
    cfg = jconfigs.get_smoke_config(arch)
    return type(cfg)(**{**cfg.__dict__, **(
        {"attn_plan": plan} if plan else {})})


def _lm_batch(cfg, seed=0):
    S = SEQ.get(cfg.name.replace("-smoke", ""), 16)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, :3] = -1          # labels < 0 are masked out of the loss
    batch = {"tokens": toks, "labels": labels}
    if cfg.enc_dec:
        batch["frames"] = _np(seed + 1, B, cfg.source_len, cfg.d_model)
    return batch


def _lm_inputs(arch, plan, batch, params, **extra):
    out = {"arch": np.array(arch), **extra,
           **{f"w/{k}": v for k, v in _flat_jax(params).items()},
           **{f"b/{k}": v for k, v in batch.items()}}
    if plan:
        out["attn_plan"] = np.array(plan)
    return out


def _loss_case(name):
    arch, plan, _ = LOSS_CASES[name]
    cfg = _jcfg(arch, plan)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    batch = _lm_batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        functools.partial(jlm.loss_fn, cfg=cfg), has_aux=True))(
            params, batch=jax.tree.map(jnp.asarray, batch))
    want = {f"g/{k}": v for k, v in _flat_jax(grads).items()}
    want.update(loss=np.asarray(loss), ce=np.asarray(metrics["ce"]),
                moe_aux=np.asarray(metrics["moe_aux"]),
                tokens=np.asarray(metrics["tokens"]))
    return _lm_inputs(arch, plan, batch, params), want


def _step_case():
    cfg = _jcfg("granite-3-2b")
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    n = 2
    batch = {k: v.reshape(n, B // n, *v.shape[1:])
             for k, v in _lm_batch(cfg).items()}
    step = jtrain.make_train_step(cfg, opt_cfg=JAdamWConfig(),
                                  num_microbatches=n, warmup=1,
                                  total_steps=10, compress_grads=True)
    p, opt, m, fb = jax.jit(step)(params, jadamw_init(params),
                                  jax.tree.map(jnp.asarray, batch),
                                  jcompression.init_error_feedback(params))
    want = {f"p/{k}": v for k, v in _flat_jax(p).items()}
    want.update({f"mu/{k}": v for k, v in _flat_jax(opt.mu).items()})
    want.update({f"e/{k}": v for k, v in _flat_jax(fb).items()})
    want.update({k: np.asarray(m[k]) for k in ("loss", "grad_norm", "ce",
                                                "tokens")})
    return _lm_inputs("granite-3-2b", None, batch, params,
                      microbatches=np.array(n)), want


def _routing_case(algorithm, dim):
    if algorithm == "dynamic":
        ins = [_np(10, 4, 16, 4, 8)]
        f = lambda u: (jbuild_router(JRouterSpec(iterations=3))(u),)
    else:
        ins = [_np(11, 4, 16, 4, 8),
               1 / (1 + np.exp(-_np(12, 4, 16))).astype(np.float32)]
        f = lambda v, a: tuple(jem.em_routing(v, a))
    outs = f(*map(jnp.asarray, ins))
    ws = [_np(20 + i, *o.shape) for i, o in enumerate(outs)]
    loss = lambda *a: sum(jnp.sum(o * w) for o, w in zip(f(*a), ws))
    grads = jax.grad(loss, argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    inputs = {"algorithm": np.array(algorithm), "dim": np.array(dim),
              "iterations": np.array(3), "n_in": np.array(len(ins)),
              **{f"in{i}": a for i, a in enumerate(ins)},
              **{f"w{i}": w for i, w in enumerate(ws)}}
    want = {f"out{i}": np.asarray(o) for i, o in enumerate(outs)}
    want.update({f"grad{i}": np.asarray(g) for i, g in enumerate(grads)})
    return inputs, want


CASES = {f"loss_{n}": ("loss_grads", functools.partial(_loss_case, n))
         for n in LOSS_CASES}
CASES["train_step"] = ("train_step", _step_case)
for _algo, _dims in (("dynamic", "BLH"), ("em", "BL")):
    for _d in _dims:
        CASES[f"routing_{_algo}_{_d}"] = (
            "routing_grads", functools.partial(_routing_case, _algo, _d))


@functools.lru_cache(maxsize=None)
def _reference(name):
    return CASES[name][1]()


def _mesh_of(name):
    if name.startswith("loss_"):
        shape = LOSS_CASES[name[5:]][2]
        return [list(shape), ["data", "model"]]
    if name.startswith("routing_"):
        return [[4], ["x"]]
    return [[2, 2], ["data", "model"]]


def _check(name, got):
    _, want = _reference(name)
    if name == "train_step":
        _check_step(got, want)
        return
    for k, w in want.items():
        tol = FWD_ATOL if k in ("loss", "ce", "moe_aux", "tokens") or \
            k.startswith("out") else GRAD_ATOL
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol,
                                   err_msg=f"{name}: {k}")


def _check_step(got, want):
    """The reference's one-step gates (``tests/test_torch_lm_train.py::
    test_one_step_matches_reference``): parameters within two learning
    rates and 99% within 1e-6, the loss, norm and moments within
    GRAD_ATOL, 99% of the error feedback within 1e-6 of its scale."""
    lr = 3e-4
    for k, w in want.items():
        g = got[k]
        if k.startswith("p/"):
            d = np.abs(g - w)
            assert d.max() <= 2 * lr + 1e-6, k
            assert np.mean(d <= 1e-6) >= 0.99, k
        elif k.startswith("e/"):
            scale = np.abs(w).max() + 1e-12
            assert np.mean(np.abs(g - w) <= 1e-6 * max(1.0, scale)) >= 0.99
        else:
            np.testing.assert_allclose(g, w, rtol=GRAD_ATOL, atol=GRAD_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_training_on_one_rank(name):
    shape, axes = _mesh_of(name)
    mesh = mesh_utils.make_mesh([1] * len(shape), axes, device=CPU)
    inputs, _ = _reference(name)
    _check(name, _torch_ranks.CASES[CASES[name][0]](dict(inputs), mesh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on its gloo ranks, then the resume: two steps on (2, 2)
    from fresh weights, two more on (1, 2) — one subprocess."""
    d = tmp_path_factory.mktemp("sharded_train_ranks")
    entries = []
    for name in sorted(CASES):
        inputs, _ = _reference(name)
        np.savez(d / f"{name}.npz", **inputs)
        shape, axes = _mesh_of(name)
        entries.append({"name": name, "case": CASES[name][0],
                        "mesh": [shape, axes],
                        "world": int(np.prod(shape))})
    cfg = _jcfg("granite-3-2b")
    batch = _lm_batch(cfg, seed=5)
    for name, shape in (("resume_a", [2, 2]), ("resume_b", [1, 2])):
        np.savez(d / f"{name}.npz", arch=np.array("granite-3-2b"),
                 ckpt_dir=np.array(str(d / "ckpt")), steps=np.array(2),
                 **{f"b/{k}": v for k, v in batch.items()})
        entries.append({"name": name, "case": "resume",
                        "mesh": [shape, ["data", "model"]],
                        "world": int(np.prod(shape))})
    (d / "cases.json").write_text(json.dumps(entries))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_ranks.py"),
         str(d)], env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = {e["name"]: dict(np.load(d / f"{e['name']}.out.npz"))
           for e in entries}
    out["ckpt_dir"] = str(d / "ckpt")
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_training_on_gloo_ranks(ranks, name):
    _check(name, ranks[name])


def test_resume_onto_a_smaller_mesh_continues(ranks):
    """The reference's gate (``tests/test_sharded.py::
    test_elastic_resume_across_mesh_sizes``): the resumed run's loss below
    the first run's last loss + 0.5."""
    a, b = ranks["resume_a"], ranks["resume_b"]
    assert int(a["start"]) == 0 and int(b["start"]) == 2
    assert np.all(np.isfinite(a["losses"])) and np.all(np.isfinite(
        b["losses"]))
    assert b["losses"][-1] < a["losses"][-1] + 0.5
    # the checkpoint holds whole leaves under the CLI's keys: the
    # reference's loader reads its parameters
    cfg = _jcfg("granite-3-2b")
    like = jax.eval_shape(lambda k: jlm.init_params(cfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    tree = jck.load_checkpoint(ranks["ckpt_dir"], 4, {"params": like})
    assert set(_flat_jax(tree["params"])) == set(_flat_jax(like))


def test_train_cli_on_a_mesh_with_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    first = ttrain_cli.main(["--smoke", "--steps", "2", "--mesh", "1,1",
                             "--device", CPU, "--ckpt-dir", d])
    assert first["start"] == 0 and len(first["losses"]) == 2
    assert tck.latest_step(d) == 2
    again = ttrain_cli.main(["--smoke", "--steps", "4", "--mesh", "1,1",
                             "--device", CPU, "--ckpt-dir", d,
                             "--microbatches", "2", "--compress-grads"])
    assert again["start"] == 2 and len(again["losses"]) == 2
    assert np.all(np.isfinite(again["losses"]))
    assert tck.latest_step(d) == 4


def test_train_cli_mesh_larger_than_the_group_raises():
    """``--mesh 2,2`` from one rank starts four ranks itself and returns
    rank 0's losses (tests/test_torch_launch.py holds them to the 1-rank
    run); ``--mesh 4`` names no mesh and is refused."""
    out = ttrain_cli.main(["--smoke", "--steps", "1", "--mesh", "2,2",
                           "--device", CPU])
    assert set(out) == {"start", "steps", "losses"}
    assert out["start"] == 0 and len(out["losses"]) == 1
    assert np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError, match="d,m or p,d,m"):
        ttrain_cli.main(["--smoke", "--steps", "1", "--mesh", "4",
                         "--device", CPU])
