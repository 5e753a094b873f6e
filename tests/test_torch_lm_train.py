"""PyTorch port, LM training (slice 10) against the JAX package on the same
numpy inputs, with the reference's weights carried across by
``convert.lm_params_from_jax``:

* ``ssm._chunked_selective_scan`` and its gradients, ``_pick_chunk`` and
  the unsharded ``sharded_softmax_xent`` against the reference's;
* ``lm.loss_fn``'s loss and whole-tree gradients against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` on the granite-3-2b and
  falcon-mamba-7b smoke configs, remat on and off, within ``GRAD_ATOL``;
  remat recomputes the attention forward (exact call counts);
* one ``make_train_step`` step's parameters against the reference's step:
  alone, over two microbatches, and with int8 compression and its error
  feedback; the loss falls over five steps on one batch;
* ``SyntheticLMDataset`` bitwise the reference's; checkpoints of the train
  CLI in the reference's format, both ways; the CLI on the CPU with a
  resume;
* the LM output guard's reference wave runs no hand-written kernel: a NaN
  from a kernel entry point inside the wave trips the guard once and the
  request completes with the plain route's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro import checkpoint as jck
from repro.data import synthetic as jsynthetic
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.runtime import compression as jcompression
from repro.runtime import train_loop as jtrain
from repro_torch import checkpoint as tck
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.ssm_scan import ops as tss_ops
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import compression as tcompression
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime import sharding as tsharding
from repro_torch.runtime import train_loop as ttrain
from repro_torch.runtime.wave_serve import ServeConfig, WaveServer

CPU = "cpu"
ARCHS = ("granite-3-2b", "falcon-mamba-7b")
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
LOGIT_GATE = 2e-4          # tests/test_models.py:79-86
B, S = 2, 12


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


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
    jcfg = type(jcfg)(**{**jcfg.__dict__, "remat": remat})
    tcfg = type(tcfg)(**{**tcfg.__dict__, "remat": remat})
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference params, port params as numpy) — the reference's
    smoke weights; each test carries them across afresh, since the port's
    step updates its parameters in place."""
    arch = request.param
    jcfg, _ = _configs(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return arch, jparams, jax.tree.map(np.asarray, jparams)


def _batch(cfg, batch=B, seq=S, index=0, masked=True):
    b = tsynthetic.SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq).batch(
        index, batch)
    if masked:                  # labels < 0 are masked out of the loss
        b["labels"][0, :3] = -1
    return b


# ---------------------------------------------------------------------------
# the chunked scan and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(16, 16), (24, 16), (20, 7), (9, 1),
                                     (32, 64)])
def test_chunked_scan_and_gradients_vs_reference(T, chunk):
    Bt, D, N = 2, 6, 4
    dt = np.log1p(np.exp(_np(0, Bt, T, D))).astype(np.float32)
    x, Bm, Cm = _np(1, Bt, T, D), _np(2, Bt, T, N), _np(3, Bt, T, N)
    A = -np.abs(_np(4, D, N))
    h0, gy, gh = _np(5, Bt, D, N), _np(6, Bt, T, D), _np(7, Bt, D, N)
    c = jssm._pick_chunk(T, chunk)
    assert tssm._pick_chunk(T, chunk) == c

    def jfn(dt, x, Bm, Cm, A, h0):
        return jssm._chunked_selective_scan(dt, dt * x, Bm, Cm, A, h0, c)

    (jy, jh), vjp = jax.vjp(jfn, dt, x, Bm, Cm, A, h0)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [torch.tensor(a, requires_grad=True) for a in (dt, x, Bm, Cm, A,
                                                         h0)]
    y, h = tssm._chunked_selective_scan(ins[0], ins[0] * ins[1], *ins[2:], c)
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)
    grads = torch.autograd.grad((y, h), ins, (torch.tensor(gy),
                                              torch.tensor(gh)))
    for name, g, jg in zip(("dt", "x", "B", "C", "A", "h0"), grads, jgrads):
        _close(g, jg, GRAD_ATOL, name)


def test_xent_matches_reference_and_vocab_axis_raises():
    """The unsharded loss, and the vocab-sharded one (slice 11) on a 1-rank
    mesh, with its gradient (several ranks: tests/test_torch_sharding.py),
    against the reference's."""
    logits, labels = _np(10, 2, 5, 37), np.random.default_rng(11).integers(
        0, 37, (2, 5))
    want = jL.sharded_softmax_xent(logits, labels, None, None)
    got = tL.sharded_softmax_xent(torch.tensor(logits), torch.tensor(labels))
    _close(got, want, 1e-5)
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)
    lg = torch.tensor(logits, requires_grad=True)
    got = tL.sharded_softmax_xent(lg, torch.tensor(labels), mesh, "model")
    _close(got, want, 1e-5)
    (g,) = torch.autograd.grad(got.sum(), lg)
    _close(g, jax.grad(lambda x: jL.sharded_softmax_xent(
        x, labels, None, None).sum())(jnp.asarray(logits)), 1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_whole_tree_gradients_vs_reference(model, remat):
    arch, _, params_np = model
    jcfg, tcfg = _configs(arch, remat)
    batch = _batch(tcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: jlm.loss_fn(p, jcfg, b),
                           has_aux=True))(jparams, batch)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(tparams).items()}
    loss, metrics = tlm.loss_fn(tparams, tcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss, jloss, GRAD_ATOL)
    _close(metrics["ce"], jmetrics["ce"], GRAD_ATOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S - 3
    want = _flat_jax(jgrads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        _close(g, want[k], GRAD_ATOL, k)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_recomputes_attention(monkeypatch, remat):
    """Each layer runs the training forward once, and once more in the
    backward under remat; the backward kernel runs once per layer."""
    _, tcfg = _configs("granite-3-2b", remat)
    calls = {"fwd_lse": 0, "bwd": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tfa_ops, "flash_attention_fwd_lse", counted(
        "fwd_lse", tfa_ops.flash_attention_fwd_lse))
    monkeypatch.setattr(tfa_ops, "flash_attention_bwd", counted(
        "bwd", tfa_ops.flash_attention_bwd))
    params, opt = ttrain.init_train_state(tcfg, device=CPU)
    step = ttrain.make_train_step(tcfg)
    step(params, opt, _batch(tcfg))
    n = tcfg.n_layers
    assert calls == {"fwd_lse": (2 if remat else 1) * n, "bwd": n}


def test_unbound_layers_give_the_per_layer_gradients():
    stacked = {"w": torch.randn(3, 4, 5, requires_grad=True)}
    views = tlm.unbind_layers(stacked, 3)
    loss = sum((v["w"] * (i + 1)).sum() for i, v in enumerate(views))
    (g,) = torch.autograd.grad(loss, stacked["w"])
    assert torch.equal(g, torch.arange(1.0, 4.0)[:, None, None].expand(
        3, 4, 5))


def test_training_surface_of_later_slices_raises():
    """Training under sharding rules (slice 8) runs: ``forward_train``,
    ``make_train_step`` and the CLI's ``--mesh 1,1`` on a 1-rank mesh give
    what the unsharded ones give (several ranks:
    tests/test_torch_sharded_train.py)."""
    _, tcfg = _configs("granite-3-2b")
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)
    rules = tsharding.make_rules(tcfg, mesh, "train")
    params = tlm.init_params(tcfg, seed=1, device=CPU)
    batch = _batch(tcfg)
    with torch.no_grad():
        want, _ = tlm.forward_train(params, tcfg, batch)
        got, _ = tlm.forward_train(tlm.shard_params(params, tcfg, rules),
                                   tcfg, batch, rules=rules)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    outs = []
    for r in (None, rules):
        p = tlm.init_params(tcfg, seed=1, device=CPU)
        step = ttrain.make_train_step(tcfg, rules=r)
        outs.append(step(p, adamw_init(tck.flatten(p)), batch))
    assert step.held["layers/attn/wq"] == ("data", "model")
    for k in ("loss", "grad_norm"):
        _close(outs[1][2][k], outs[0][2][k].numpy(), 1e-5, k)
    for k, v in tck.flatten(outs[1][0]).items():
        _close(v, tck.flatten(outs[0][0])[k].numpy(), 1e-5, k)
    res = ttrain_cli.main(["--smoke", "--device", CPU, "--mesh", "1,1",
                           "--steps", "2"])
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    with pytest.raises(ValueError, match="route must be"):
        tL.attention_forward({}, torch.zeros(1, 2, 4), None, n_heads=1,
                             n_kv=1, d_head=4, rope_theta=1e4, route="fast")
    with pytest.raises(ValueError, match="route must be"):
        tlm.prefill(None, tcfg, {"tokens": np.zeros((1, 2), np.int32)}, 4,
                    route="fast")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "microbatches", "compressed"])
def test_one_step_matches_reference(model, variant):
    """One AdamW step (warmup 1, so lr is the full 3e-4): the parameters
    within two learning rates of the reference's and 99% of them within
    1e-6 (AdamW's first step is lr·sign(g) wherever |g| >> eps, so a
    gradient that differs by round-off near zero moves its parameter by up
    to lr), the loss and grad norm within GRAD_ATOL."""
    arch, _, params_np = model
    jcfg, tcfg = _configs(arch)
    n = 2 if variant == "microbatches" else 1
    compress = variant == "compressed"
    kw = dict(num_microbatches=n, warmup=1, total_steps=10,
              compress_grads=compress)
    batch = _batch(tcfg, batch=4)
    if n > 1:
        batch = {k: v.reshape(n, 4 // n, S) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstep = jtrain.make_train_step(jcfg, opt_cfg=JAdamWConfig(), **kw)
    jargs = (jparams, jadamw_init(jparams), batch)
    if compress:
        jargs += (jcompression.init_error_feedback(jparams),)
    jout = jstep(*jargs)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
    tstep = ttrain.make_train_step(tcfg, opt_cfg=AdamWConfig(), **kw)
    targs = (tparams, adamw_init(tck.flatten(tparams)), batch)
    if compress:
        targs += (tcompression.init_error_feedback(tck.flatten(tparams)),)
    tout = tstep(*targs)
    assert len(tout) == len(jout) == (4 if compress else 3)
    assert tout[0] is tparams and int(tout[1].step) == 1
    for key in ("loss", "grad_norm", "lr_scale", "ce", "tokens"):
        _close(tout[2][key], jout[2][key], GRAD_ATOL, key)
    want = _flat_jax(jout[0])
    lr = 3e-4
    for k, p in tck.flatten(tout[0]).items():
        d = np.abs(p.float().numpy() - want[k])
        assert d.max() <= 2 * lr + 1e-6, k
        assert np.mean(d <= 1e-6) >= 0.99, k
    for moment in ("mu", "nu"):
        want_m = _flat_jax(getattr(jout[1], moment))
        for k, m in getattr(tout[1], moment).items():
            _close(m, want_m[k], GRAD_ATOL, f"{moment} {k}")
    if compress:
        want_e = _flat_jax(jout[3])
        for k, e in tout[3].items():
            scale = np.abs(want_e[k]).max() + 1e-12
            assert np.mean(np.abs(e.numpy() - want_e[k]) <= 1e-6 * max(
                1.0, scale)) >= 0.99, k


def test_compression_matches_reference():
    g = {"a": _np(20, 5, 7), "b": _np(21, 3) * 1e-3}
    e = {"a": _np(22, 5, 7) * 0.01, "b": np.zeros(3, np.float32)}
    jg, je = jcompression.compress_grads_with_feedback(g, e)
    tg, te = tcompression.compress_grads_with_feedback(
        {k: torch.tensor(v) for k, v in g.items()},
        {k: torch.tensor(v) for k, v in e.items()})
    for k in g:
        _close(tg[k], jg[k], 1e-6)
        _close(te[k], je[k], 1e-6)
    q, s = tcompression.quantize_int8(torch.tensor([0.5, 1.5, 2.5, -127.0]))
    assert q.dtype == torch.int8 and q.tolist() == [0, 2, 2, -127]
    assert float(s) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_falls_on_one_repeated_batch(arch):
    _, tcfg = _configs(arch)
    params, opt = ttrain.init_train_state(tcfg, device=CPU)
    step = ttrain.make_train_step(tcfg, opt_cfg=AdamWConfig(lr=1e-3),
                                  warmup=1, total_steps=100)
    batch = _batch(tcfg, masked=False)
    losses = []
    for _ in range(5):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.05, losses


# ---------------------------------------------------------------------------
# data, checkpoints and the CLI
# ---------------------------------------------------------------------------

def test_lm_dataset_and_iterator_bitwise_equal_reference():
    for seed, index, bs in ((0, 0, 4), (3, 17, 2)):
        t = tsynthetic.SyntheticLMDataset(vocab=250, seq_len=9, seed=seed)
        j = jsynthetic.SyntheticLMDataset(vocab=250, seq_len=9, seed=seed)
        tb, jb = t.batch(index, bs), j.batch(index, bs)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    ds_t = tsynthetic.SyntheticLMDataset(vocab=50, seq_len=4)
    ds_j = jsynthetic.SyntheticLMDataset(vocab=50, seq_len=4)
    it_t = tsynthetic.lm_batch_iterator(ds_t, 4, start_step=5, shard=(1, 2))
    it_j = jsynthetic.lm_batch_iterator(ds_j, 4, start_step=5, shard=(1, 2))
    for _ in range(2):
        tb, jb = next(it_t), next(it_j)
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


def test_checkpoints_in_the_reference_format_both_ways(tmp_path, model):
    arch, _, params_np = model
    jcfg, tcfg = _configs(arch)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device=CPU)
    opt = adamw_init(tck.flatten(tparams))
    opt = opt._replace(step=opt.step + 4,
                       mu={k: v + 0.5 for k, v in opt.mu.items()})
    out = str(tmp_path / "port")
    tck.save_checkpoint(out, 4, ttrain_cli.checkpoint_tree(tparams, opt))
    jparams = jax.tree.map(jnp.asarray, params_np)
    target = {"params": jparams, "opt": jadamw_init(jparams)}
    loaded = jck.load_checkpoint(out, 4, target)
    assert int(loaded["opt"].step) == 4
    flat_np = _flat_jax(params_np)
    for k, v in _flat_jax(loaded["params"]).items():
        np.testing.assert_array_equal(v, flat_np[k])
    for k, v in _flat_jax(loaded["opt"].mu).items():
        np.testing.assert_array_equal(v, opt.mu[k].numpy())
    # the other way: the reference's tree, restored by the port's CLI code
    back = str(tmp_path / "ref")
    jck.save_checkpoint(back, 9, {"params": loaded["params"],
                                  "opt": loaded["opt"]})
    fresh, fresh_opt = ttrain.init_train_state(tcfg, device=CPU)
    p2, o2 = ttrain_cli.restore(back, 9, fresh, fresh_opt)
    assert int(o2.step) == 4 and o2.mu.keys() == opt.mu.keys()
    for k, v in tck.flatten(p2).items():
        assert torch.equal(v, tck.flatten(tparams)[k]), k
    for k in opt.mu:
        assert torch.equal(o2.mu[k], opt.mu[k]) and torch.equal(
            o2.nu[k], opt.nu[k]), k


def test_train_cli_on_cpu_with_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    base = ["--smoke", "--device", CPU, "--seq", "16", "--global-batch",
            "4", "--ckpt-dir", ckpt]
    first = ttrain_cli.main(base + ["--steps", "3"])
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert tck.latest_step(ckpt) == 3
    second = ttrain_cli.main(base + ["--steps", "5", "--microbatches", "2",
                                     "--compress-grads"])
    assert second["start"] == 3 and len(second["losses"]) == 2
    assert int(second["opt"].step) == 5 and tck.latest_step(ckpt) == 5
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and out.count("done") == 2
    assert all(np.isfinite(first["losses"] + second["losses"]))
    mamba = ttrain_cli.main(["--smoke", "--arch", "falcon-mamba-7b",
                             "--device", CPU, "--seq", "8", "--steps", "2",
                             "--global-batch", "2"])
    assert len(mamba["losses"]) == 2


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# the LM output guard (the reference wave runs no hand-written kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,module,entry", [
    ("granite-3-2b", tfa_ops, "attention"),
    ("falcon-mamba-7b", tss_ops, "scan")])
def test_guard_reruns_a_kernel_fault_on_the_plain_route(monkeypatch, arch,
                                                        module, entry):
    """A NaN from the prefill's kernel entry point trips the output guard
    once; the quarantine re-run takes the plain route, which calls no
    kernel entry point, so the request completes with the plain route's
    tokens."""
    _, tcfg = _configs(arch)
    params = tlm.init_params(tcfg, seed=1, device=CPU)
    prompts = np.random.default_rng(12).integers(0, tcfg.vocab, (2, 6),
                                                 dtype=np.int32)
    want, _ = tserve.generate(params, tcfg, {"tokens": prompts}, 3,
                              route="plain")
    calls = []
    clean = getattr(module, entry)

    def faulty(*args, **kwargs):
        calls.append(1)
        out = clean(*args, **kwargs)
        if isinstance(out, tuple):
            return (torch.full_like(out[0], float("nan")),) + out[1:]
        return torch.full_like(out, float("nan"))

    monkeypatch.setattr(module, entry, faulty)
    adapter = tserve.LMDecodeAdapter(params, tcfg, prompt_len=6,
                                     max_new_tokens=3)
    server = WaveServer(adapter, cfg=ServeConfig(microbatch=2, n_micro=1,
                                                 pipeline=None))
    server.submit(prompts)
    done = server.drain()
    s = server.metrics.summary()
    assert s["guard_trips"] == 1 and s["failed"] == 0, s
    assert s["completed"] == 2 and s["wave_errors"] == 0, s
    assert len(calls) == tcfg.n_layers     # the wave only
    got = np.stack([c.pred for c in sorted(done, key=lambda c: c.rid)])
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_route_prefill_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (2, 11),
                                              dtype=np.int32)
    jlg, _ = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 12)
    for route in ("kernels", "plain"):
        lg, st = tlm.prefill(tparams, tcfg, {"tokens": toks}, 12, route=route)
        _close(lg, jlg, LOGIT_GATE, route)
        assert st.pos.tolist() == [11, 11]
