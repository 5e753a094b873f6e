"""PyTorch port, the CapsNet training path against the JAX reference with
the reference's weights carried across (``repro_torch.convert``):

* the router's differentiable resolution and error surface (the cases of
  ``tests/test_router.py``'s differentiable tests), the budget fallback to
  plain autograd;
* AdamW on identical numpy gradients, weight decay on matrices only, global
  norm clipping and the schedules;
* ``capsnet.loss_fn`` and the full parameter-tree gradients at the smoke
  config — exact torch routing, the cuda router's plain path and approx
  routing — against ``jax.grad`` of the reference's ``loss_fn``; one step
  lowers the loss; ``opt_cfg`` isolation (the CapsNet and the LM step);
* the layer constructors default to the card;
* checkpoints in the reference's format both ways, ``capsnet_to_jax``, the
  step-indexed data iterator, the straggler watchdog copy, and the training
  CLI.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import optim as joptim
from repro.configs.caps_benchmarks import smoke_caps
from repro.core import router as jrouter
from repro.data import synthetic as jsynthetic
from repro.kernels.routing import ops as jops
from repro.models import capsnet as jcapsnet
from repro.runtime import straggler as jstraggler
from repro.runtime import train_loop as jtrain
from repro_torch import checkpoint as tck
from repro_torch import configs as tconfigs_lm
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.core import approx as tapprox
from repro_torch.core import capsule_layers as TCL
from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels.routing import kernel as tkernel
from repro_torch.models import capsnet as tcapsnet
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import straggler as tstraggler
from repro_torch.runtime import train_loop as ttrain

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CPU = "cpu"
GRAD_TOL = 1e-4
CONV_W = {"primary.conv1.w", "primary.caps_conv.w"}


def _votes(shape=(2, 64, 6, 8), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _setup(batch: int = 4, seed: int = 0):
    """Reference params (non-zero biases), the port's net holding them, and
    a synthetic batch."""
    cfg = smoke_caps()
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(np.float32) if a.ndim == 1 else a, params)
    net = convert.capsnet_from_jax(jax.tree.map(np.asarray, params),
                                   tconfigs.smoke_caps(), device=CPU)
    b = jsynthetic.SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                                        cfg.num_h_caps).batch(seed, batch)
    return cfg, params, net, b["images"], b["labels"]


def _jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if name in CONV_W else a


def _flat_jax(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(net, images, labels, router) -> dict:
    params = dict(net.named_parameters())
    loss, _ = tcapsnet.loss_fn(net, torch.from_numpy(images),
                               torch.from_numpy(labels), router=router)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k.replace(".", "/"): _jax_layout(k, g)
            for k, g in zip(params, grads)}


def _assert_trees_close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# router: differentiable resolution and errors
# ---------------------------------------------------------------------------

def test_differentiable_router_grad_matches_torch_backend():
    u = torch.from_numpy(_votes((4, 64, 8, 16), seed=1))
    w = torch.from_numpy(_votes((4, 8, 16), seed=2))
    fused = build_router(RouterSpec(backend="cuda", differentiable=True),
                         device=CPU)
    ref = build_router(RouterSpec(), device=CPU)
    resolved = fused.resolve(u)
    assert resolved.fusion == "procedure" and resolved.differentiable
    assert not ref.resolve(u).differentiable
    grads = []
    for r in (fused, ref):
        x = u.clone().requires_grad_()
        torch.sum(r(x) * w).backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=GRAD_TOL)


def test_differentiable_auto_plan_resolves_shard_local():
    u = torch.from_numpy(_votes())
    spec = RouterSpec(backend="cuda", differentiable=True)
    resolved = build_router(spec, "auto", device=CPU).resolve(u)
    assert tuple(resolved) == ()
    assert resolved.fusion == "procedure" and resolved.differentiable
    jres = jrouter.build_router(jrouter.RouterSpec(
        backend="pallas", differentiable=True), "auto").resolve(
        jnp.asarray(u.numpy()))
    assert (tuple(resolved), resolved.fusion, resolved.differentiable) == \
        (tuple(jres), jres.fusion, jres.differentiable)
    # without differentiable, auto is the planner's: a sharded dim on the
    # stage-split kernels
    sharded = build_router(RouterSpec(backend="cuda"), "auto",
                           device=CPU).resolve(u)
    assert len(sharded) == 1 and sharded.fusion == "stage_split"
    # a sharded plan on the torch backend trains (slice 8): the planner's
    # sharded pick, differentiable by autograd through the collectives
    step = ttrain.make_capsnet_train_step(tconfigs.smoke_caps(),
                                          RouterSpec(), "auto", device=CPU)
    picked = step.router.resolve(u)
    assert len(picked) == 1 and step.router.spec.differentiable


def test_differentiable_validation_errors():
    spec = RouterSpec(backend="cuda", differentiable=True)
    mesh = mesh_utils.make_mesh((1,), ("x",), device=CPU)
    with pytest.raises(ValueError, match="shard-local"):
        build_router(spec, ExecutionPlan(mesh=mesh, axes=(("L", "x"),)),
                     device=CPU)
    with pytest.raises(ValueError, match="shard-local"):
        build_router(spec, ExecutionPlan(pipeline="software"), device=CPU)
    with pytest.raises(ValueError, match="no derivative"):
        build_router(spec._replace(use_approx=True), device=CPU)
    with pytest.raises(ValueError, match="no custom VJP"):
        build_router(spec._replace(fusion="iteration"), device=CPU)
    with pytest.raises(ValueError, match="dequant path"):
        build_router(spec._replace(stream_dtype="int8"), device=CPU)
    with pytest.raises(ValueError, match="replays the fixed-grid"):
        build_router(spec._replace(early_exit_eps=0.0), device=CPU)
    # the EM kernels have no backward: the reference's error
    with pytest.raises(ValueError, match="requires the 'dynamic' algorithm"):
        build_router(RouterSpec(algorithm="em", backend="cuda",
                                differentiable=True), device=CPU)
    # the torch backend is differentiable by construction
    build_router(RouterSpec(differentiable=True, use_approx=True),
                 ExecutionPlan(pipeline="software"), device=CPU)


def test_differentiable_budget_fallback_is_plain_autograd(monkeypatch):
    """Where the procedure form does not fit, the differentiable router
    falls back to autograd of the torch path (reported as the torch
    resolution), never to a forward-only kernel."""
    from repro_torch.kernels.routing import ops as rt_ops
    monkeypatch.setattr(rt_ops, "PROCEDURE_VMEM_BUDGET", 1024)
    router = build_router(RouterSpec(backend="cuda", differentiable=True),
                          device=CPU)
    u = torch.ones((2, 64, 6, 8), requires_grad=True)
    resolved = router.resolve(u)
    assert resolved.fusion is None and not resolved.differentiable
    monkeypatch.setattr(jops, "PROCEDURE_VMEM_BUDGET", 1024)
    jres = jrouter.build_router(jrouter.RouterSpec(
        backend="pallas", differentiable=True))
    assert jres.resolve(jnp.ones((2, 64, 6, 8))).differentiable is False
    calls = []
    monkeypatch.setattr(tkernel, "routing_procedure_bwd_plain",
                        lambda *a, **k: calls.append(1))
    torch.sum(router(u) ** 2).backward()
    assert bool(torch.isfinite(u.grad).all()) and not calls


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def _param_tree(rng):
    return {"conv/w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
            "conv/b": rng.standard_normal((4,)).astype(np.float32),
            "dense/w": rng.standard_normal((6, 5)).astype(np.float32)}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split("/")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference_on_identical_gradients(weight_decay):
    rng = np.random.default_rng(0)
    params = _param_tree(rng)
    cfg_j = joptim.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    cfg_t = toptim.AdamWConfig(lr=1e-2, weight_decay=weight_decay)
    assert tuple(cfg_j) == tuple(cfg_t)
    jp = jax.tree.map(jnp.asarray, _nest(params))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jstate, tstate = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        scale = 0.5 + 0.25 * step
        jp, jstate = joptim.adamw_update(
            jax.tree.map(jnp.asarray, _nest(grads)), jstate, jp, cfg_j, scale)
        tp, tstate = toptim.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tp,
            cfg_t, scale)
        assert int(tstate.step) == int(jstate.step) == step + 1
        flat = _flat_jax(jp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), flat[k], rtol=0,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(
                tstate.nu[k].numpy(), _flat_jax(jstate.nu)[k], rtol=1e-6,
                atol=1e-9)


def test_adamw_decays_matrices_only():
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    zero = {k: torch.zeros_like(v) for k, v in p.items()}
    new, _ = toptim.adamw_update(zero, toptim.adamw_init(p), p,
                                 toptim.AdamWConfig(lr=0.1, weight_decay=0.5))
    torch.testing.assert_close(new["w"], torch.full((2, 2), 0.95))
    torch.testing.assert_close(new["b"], torch.ones(2))
    assert p["w"].eq(1.0).all()          # the update is pure


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    grads = _param_tree(rng)
    jg, jn = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, _nest(grads)), max_norm)
    tg, tn = toptim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(toptim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)
    for k, v in _flat_jax(jg).items():
        np.testing.assert_allclose(tg[k].numpy(), v, rtol=1e-6, atol=1e-7)


def test_schedules_match_reference():
    for step in (0, 1, 5, 20, 21, 57, 100, 150):
        for warmup, total in ((20, 100), (1, 10), (0, 0)):
            np.testing.assert_allclose(
                float(toptim.linear_warmup_cosine(step, warmup, total)),
                float(joptim.linear_warmup_cosine(jnp.asarray(step), warmup,
                                                  total)),
                rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(toptim.cosine_schedule(torch.tensor(step), 80, 0.2)),
            float(joptim.cosine_schedule(jnp.asarray(step), 80, 0.2)),
            rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the loss, the gradients and the step
# ---------------------------------------------------------------------------

def test_loss_fn_matches_reference():
    cfg, params, net, x, y = _setup(seed=1)
    jl, jm = jax.jit(lambda p, a, b: jcapsnet.loss_fn(p, a, b, cfg))(
        params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        tl, tm = tcapsnet.loss_fn(net, torch.from_numpy(x),
                                  torch.from_numpy(y))
    assert abs(float(tl) - float(jl)) <= 1e-5
    for key in ("margin", "recon", "accuracy"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5, key


@pytest.mark.parametrize("routing", ["exact", "cuda-plain", "approx"])
def test_parameter_gradients_match_reference(routing):
    """The whole tree's gradients against jax.grad of the reference's
    loss_fn: exact torch routing vs jnp autodiff, the cuda router's plain
    path (the autograd Function over the kernels' plain versions) vs the
    pallas custom VJP, and approx routing vs jnp autodiff through the
    reference's bit-level functions."""
    cfg, params, net, x, y = _setup(seed=2)
    if routing == "cuda-plain":
        jspec = jrouter.RouterSpec(backend="pallas", differentiable=True,
                                   iterations=cfg.routing_iters)
        tspec = RouterSpec(backend="cuda", differentiable=True,
                           iterations=cfg.routing_iters)
    else:
        approx = routing == "approx"
        jspec = jrouter.RouterSpec(iterations=cfg.routing_iters,
                                   use_approx=approx)
        tspec = RouterSpec(iterations=cfg.routing_iters, use_approx=approx)
    jr = jrouter.build_router(jspec)
    want = jax.jit(jax.grad(lambda p, a, b: jcapsnet.loss_fn(
        p, a, b, cfg, router=jr)[0]))(params, jnp.asarray(x), jnp.asarray(y))
    tr = build_router(tspec, device=CPU)
    if routing == "cuda-plain":
        assert tr.resolve(torch.zeros((4, 288, 10, 16))).differentiable
    got = _port_grads(net, x, y, tr)
    _assert_trees_close(got, _flat_jax(want), GRAD_TOL)


def test_approx_softmax_gradient_is_the_references_zero():
    """Fault 3: the bitcast cuts the tangent in the reference, so the
    gradient of approx_softmax is exactly 0 — a zero, not an error."""
    b = _votes((5, 6), seed=3)
    w = _votes((5, 6), seed=4)
    from repro.core import approx as japprox
    want = jax.grad(lambda t: jnp.sum(japprox.approx_softmax(t) * w))(
        jnp.asarray(b))
    t = torch.from_numpy(b).requires_grad_()
    torch.sum(tapprox.approx_softmax(t) * torch.from_numpy(w)).backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert not t.grad.any()
    s = _votes((3, 6, 8), seed=5)
    ws = _votes((3, 6, 8), seed=6)
    want = jax.grad(lambda t: jnp.sum(japprox.approx_squash(t) * ws))(
        jnp.asarray(s))
    t = torch.from_numpy(s).requires_grad_()
    torch.sum(tapprox.approx_squash(t) * torch.from_numpy(ws)).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_train_step_auto_plan_trains_through_the_kernels(monkeypatch):
    """plan='auto' resolves to the differentiable procedure form; one step
    lowers the loss on its own batch, with one forward and one backward
    kernel call per step (their plain versions here)."""
    cfg, params, net, x, y = _setup(seed=3)
    step = ttrain.make_capsnet_train_step(
        tconfigs.smoke_caps(), plan="auto",
        opt_cfg=toptim.AdamWConfig(weight_decay=0.0), warmup=1,
        total_steps=100, device=CPU)
    assert step.router.spec.backend == "cuda"
    assert step.router.spec.differentiable
    resolved = step.router.resolve(torch.zeros((4, 288, 10, 16)))
    assert resolved.fusion == "procedure" and resolved.differentiable
    assert tuple(resolved) == ()
    images, labels = torch.from_numpy(x), torch.from_numpy(y)
    calls = []
    orig = tkernel.routing_procedure_bwd_plain
    monkeypatch.setattr(tkernel, "routing_procedure_bwd_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    opt = toptim.adamw_init(dict(net.named_parameters()))
    net2, opt, metrics = step(net, opt, images, labels)
    assert net2 is net and len(calls) == 1
    assert int(opt.step) == 1 and bool(torch.isfinite(metrics["loss"]))
    with torch.no_grad():
        after, _ = tcapsnet.loss_fn(net, images, labels, router=step.router)
    assert float(after) < float(metrics["loss"])


def test_train_step_matches_reference_step():
    """One whole step (grads, clip, schedule, AdamW) from the same weights:
    parameters agree after the step.  AdamW's first update is close to
    lr·sign(g), so the tolerance is lr·2 on elements whose gradient is at
    noise level, and the bulk must agree to 1e-6."""
    cfg, params, net, x, y = _setup(seed=4)
    jstep = jtrain.make_capsnet_train_step(cfg, warmup=1, total_steps=10)
    tstep = ttrain.make_capsnet_train_step(tconfigs.smoke_caps(), warmup=1,
                                           total_steps=10, device=CPU)
    jp, _, jm = jax.jit(jstep)(params, joptim.adamw_init(params),
                               jnp.asarray(x), jnp.asarray(y))
    opt = toptim.adamw_init(dict(net.named_parameters()))
    _, opt, tm = tstep(net, opt, torch.from_numpy(x), torch.from_numpy(y))
    for key in ("loss", "lr_scale", "margin", "recon"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    # the norm sums every element's GRAD_ATOL-level difference
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)
    want = _flat_jax(jp)
    lr = tstep.opt_cfg.lr
    for name, p in net.named_parameters():
        d = np.abs(_jax_layout(name, p) - want[name.replace(".", "/")])
        assert d.max() <= 2 * lr + 1e-6, name
        assert np.mean(d <= 1e-6) >= 0.99, name


def test_train_step_opt_cfg_isolation():
    cfg = tconfigs.smoke_caps()
    s1 = ttrain.make_capsnet_train_step(cfg, device=CPU)
    s2 = ttrain.make_capsnet_train_step(
        cfg, opt_cfg=toptim.AdamWConfig(lr=9.0), device=CPU)
    s3 = ttrain.make_capsnet_train_step(cfg, device=CPU)
    assert s1.opt_cfg == toptim.AdamWConfig() == s3.opt_cfg
    assert s2.opt_cfg.lr == 9.0 and s3.opt_cfg.lr != 9.0
    assert s1.router.spec.backend == "torch" and s1.router.spec.differentiable
    assert tuple(toptim.AdamWConfig()) == tuple(joptim.AdamWConfig())
    lm_cfg = tconfigs_lm.get_smoke_config("granite-3-2b")
    l1 = ttrain.make_train_step(lm_cfg)
    l2 = ttrain.make_train_step(lm_cfg, opt_cfg=toptim.AdamWConfig(lr=9.0))
    l3 = ttrain.make_train_step(lm_cfg)
    assert l1.opt_cfg == toptim.AdamWConfig() == l3.opt_cfg
    assert l1.opt_cfg is not l3.opt_cfg
    assert l2.opt_cfg.lr == 9.0 and l3.opt_cfg.lr != 9.0


def test_train_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_capsnet_train_step(tconfigs.smoke_caps(), plan="auto")


@pytest.mark.parametrize("layer", ["conv", "primary", "caps", "dense",
                                   "decoder"])
def test_layer_constructors_default_to_the_card(layer):
    """Fault 2: no layer quietly lands on the CPU."""
    build = {
        "conv": lambda **kw: TCL.Conv2d(3, 3, 1, 4, **kw),
        "primary": lambda **kw: TCL.PrimaryCaps(
            1, TCL.PrimaryCapsConfig(conv1_channels=4, caps_channels=2),
            **kw),
        "caps": lambda **kw: TCL.CapsLayer(8, 3, 4, 5, **kw),
        "dense": lambda **kw: TCL.Dense(4, 3, **kw),
        "decoder": lambda **kw: TCL.Decoder(3, 4, 9, hidden=(5,), **kw),
    }[layer]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    m = build(device="cpu")
    ps = list(m.parameters())
    assert ps and all(p.device.type == "cpu" and p.requires_grad
                      for p in ps)


# ---------------------------------------------------------------------------
# checkpoints, data, straggler, CLI
# ---------------------------------------------------------------------------

def test_port_checkpoint_loads_in_reference(tmp_path):
    cfg, params, net, x, _ = _setup(seed=5)
    path = tck.save_checkpoint(str(tmp_path), 7, convert.capsnet_to_jax(net))
    assert tck.latest_step(str(tmp_path)) == jck.latest_step(str(tmp_path)) \
        == 7
    zeros = jax.tree.map(jnp.zeros_like, params)
    loaded = jck.load_checkpoint(str(tmp_path), 7, zeros)
    for key, want in _flat_jax(params).items():
        np.testing.assert_array_equal(_flat_jax(loaded)[key], want)
    back = convert.load_jax_checkpoint(path, tconfigs.smoke_caps(),
                                       device=CPU)
    for (n1, p1), (n2, p2) in zip(net.named_parameters(),
                                  back.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)
    out = jcapsnet.forward(loaded, jnp.asarray(x), cfg)
    with torch.no_grad():
        got = tcapsnet.forward(back, torch.from_numpy(x))
    np.testing.assert_allclose(got["v"].numpy(), np.asarray(out["v"]),
                               rtol=0, atol=1e-5)


def test_reference_checkpoint_loads_in_port(tmp_path):
    _, params, net, _, _ = _setup(seed=6)
    jck.save_checkpoint(str(tmp_path), 3, params)
    target = convert.capsnet_to_jax(net)
    tree = tck.load_checkpoint(str(tmp_path), 3, target)
    flat = tck.flatten(tree)
    for key, want in _flat_jax(params).items():
        np.testing.assert_array_equal(flat[key], want)
    loaded = convert.capsnet_from_jax(tree, tconfigs.smoke_caps(),
                                      device=CPU)
    for name, p in loaded.named_parameters():
        np.testing.assert_array_equal(_jax_layout(name, p),
                                      _flat_jax(params)[name.replace(
                                          ".", "/")])
    # tensor targets come back as tensors of the target's dtype
    as_t = tck.load_checkpoint(str(tmp_path), 3, {"digit": {
        "W": torch.zeros(params["digit"]["W"].shape)}})
    assert isinstance(as_t["digit"]["W"], torch.Tensor)
    with pytest.raises(KeyError, match="missing leaf"):
        tck.load_checkpoint(str(tmp_path), 3, {"nope": np.zeros(1)})


def test_async_checkpointer_keeps_the_newest(tmp_path):
    net = tcapsnet.CapsNet(tconfigs.smoke_caps(), device=CPU, seed=1)
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, convert.capsnet_to_jax(net))
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    with open(os.path.join(tmp_path, "step_00000003", "manifest.json")) as f:
        assert '"primary/conv1/w"' in f.read()


def test_capsnet_to_jax_is_the_inverse_of_capsnet_from_jax():
    _, params, net, _, _ = _setup(seed=7)
    tree = convert.capsnet_to_jax(net)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray, params))
    for key, want in _flat_jax(params).items():
        np.testing.assert_array_equal(_flat_jax(tree)[key], want)


def test_batch_iterator_and_straggler_copies_match_reference():
    cfg = smoke_caps()
    jds = jsynthetic.SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                                          cfg.num_h_caps)
    tds = tsynthetic.SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                                          cfg.num_h_caps)
    jit = jsynthetic.caps_batch_iterator(jds, 3, start_step=5)
    tit = tsynthetic.caps_batch_iterator(tds, 3, start_step=5)
    for _ in range(2):
        a, b = next(jit), next(tit)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    ticks = [0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 10.0]
    slow = {}
    for mod in (jstraggler, tstraggler):
        it = iter(ticks)
        wd = mod.StepWatchdog(clock=lambda: next(it), slow_factor=3.0)
        assert wd.stop() is None
        for s in range(4):
            wd.start(s)
            wd.stop()
        slow[mod.__name__] = (wd.slow_steps, wd.median(), wd.percentile(0.9))
        assert list(mod.Prefetcher(iter(range(5)), depth=2)) == list(range(5))
    assert slow["repro.runtime.straggler"] == \
        slow["repro_torch.runtime.straggler"] == ([3], 1.0, 7.0)


def test_train_cli_resumes_and_checkpoints_on_cpu(tmp_path):
    """A checkpoint at step 1 in the reference's format; the CLI resumes
    from it, trains step 2 through the backward kernel's plain version and
    writes step 2."""
    ckpt = str(tmp_path / "ckpt")
    net = tcapsnet.CapsNet(tconfigs.smoke_caps(), device=CPU, seed=3)
    tck.save_checkpoint(ckpt, 1, convert.capsnet_to_jax(net))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_capsnet", "--smoke",
         "--steps", "2", "--ckpt-every", "2", "--device", "cpu",
         "--routing", "fused", "--ckpt-dir", ckpt],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 1" in out.stdout
    assert "eval accuracy (fused routing)" in out.stdout
    assert tck.latest_step(ckpt) == 2
    trained = convert.load_jax_checkpoint(
        os.path.join(ckpt, "step_00000002"), tconfigs.smoke_caps(),
        device=CPU)
    moved = [not torch.equal(a, b) for a, b in zip(net.parameters(),
                                                   trained.parameters())]
    assert any(moved)


def test_train_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import train_capsnet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_capsnet.main(["--smoke", "--steps", "2", "--ckpt-dir",
                            str(tmp_path)])
