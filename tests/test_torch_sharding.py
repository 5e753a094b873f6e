"""PyTorch port, the LM sharding tables (slice 11) against the JAX package:

* ``runtime.sharding.make_rules``, rule by rule, for the ten architectures
  × train/prefill/decode × the meshes (1, 1), (2, 2), (2, 4), (16, 16) and
  (2, 16, 16) — the reference on a ``jax.sharding.AbstractMesh``, the port
  on a stand-in with a ``DeviceMesh``'s axis names and sizes (no process
  group needed);
* ``lm.param_logical_axes`` leaf by leaf for the ten full configs (the
  reference's ``eval_shape`` against the port's meta tensors), the
  ``PartitionSpec`` tree, the local shapes and ``shard_params`` /
  ``gather_params`` round trips;
* ``batch_shape_check`` and ``rebatch_for_mesh`` against the reference's;
* on a 1-rank (data, model) gloo mesh in-process and on four CPU gloo
  ranks in one subprocess (``tests/_torch_ranks.py``, a ``FileStore`` in
  tmp_path, importing only ``repro_torch``): the vocab-sharded xent's
  values and gradients (a vocab the axis divides, the smoke vocab 250
  padded to 256, and one it does not divide), flash-decoding at the
  reference's ``test_sharded_xent_and_flash_decode`` shapes (plain, the
  rolling window, a static memory), and ``moe_forward(rules=...)`` with
  capacity drops against the reference's unsharded function (and without
  drops against its dense oracle), and the collectives against their
  definitions with their backward formulas held to the exact transposes
  (the adjoint identity, float64).  The reference's values come from
  this process.
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
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import elastic as jelastic
from repro.runtime import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.models import lm as tlm
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import sharding as tsharding

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ranks  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(tconfigs.list_archs())
MESHES = ((1, 1), (2, 2), (2, 4), (16, 16), (2, 16, 16))
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


class _Mesh:
    """A ``DeviceMesh``'s axis names and sizes, without a process group."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.mesh_dim_names = AXES[len(shape)]

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]

    def get_local_rank(self, axis):
        return 0


@functools.lru_cache(maxsize=None)
def _count(cfg):
    return cfg.param_count()


@pytest.fixture(autouse=True)
def _cached_param_count(monkeypatch):
    """``make_rules`` counts parameters in serving modes; count each
    config once."""
    monkeypatch.setattr(type(jconfigs.get_config("granite-3-2b")),
                        "param_count", _count)
    monkeypatch.setattr(tlm.ArchConfig, "param_count", _count)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_rules_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tcfg.attn_plan == jcfg.attn_plan
    for shape in MESHES:
        jmesh, tmesh = AbstractMesh(shape, AXES[len(shape)]), _Mesh(shape)
        for mode in ("train", "prefill", "decode"):
            want = jsharding.make_rules(jcfg, jmesh, mode).rules
            got = tsharding.make_rules(tcfg, tmesh, mode)
            assert got.enabled and got.mesh is tmesh
            assert dict(got.rules) == dict(want), (shape, mode)
            for ax in (("embed", "qkv_out"), ("batch", "seq", None)):
                assert tuple(got.spec(*ax)) == tuple(
                    jsharding.make_rules(jcfg, jmesh, mode).spec(*ax))
    over = tsharding.make_rules(tcfg, _Mesh((2, 2)), "train",
                                {"vocab": None})
    assert over.rules["vocab"] is None
    with pytest.raises(ValueError, match="mode must be"):
        tsharding.make_rules(tcfg, _Mesh((2, 2)), "serve")


def _flat_axes(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want = _flat_axes(jlm.param_logical_axes(jcfg))
    got = flatten(tlm.param_logical_axes(tcfg))
    assert got == want
    rules = tsharding.make_rules(tcfg, _Mesh((2, 16, 16)), "train")
    specs = flatten(tlm.param_shardings(tcfg, rules))
    assert {k: tuple(v) for k, v in specs.items()} == {
        k: tuple(rules.spec(*ax)) for k, ax in want.items()}
    # the local shapes from meta tensors: a dimension is split where its
    # axis size divides it
    shapes = flatten(tlm.init_params(tcfg, device="meta"))
    for k, ax in want.items():
        loc = tlm.local_shape(tuple(shapes[k].shape), ax, rules)
        for n, m, a in zip(shapes[k].shape, loc, ax):
            mesh_ax = rules.rules.get(a) if a else None
            size = 16 if mesh_ax in ("data", "model") else 1
            assert m == (n // size if n % size == 0 else n), (k, ax)


def test_shard_and_gather_params_round_trip():
    cfg = tconfigs.get_smoke_config("granite-3-2b")
    params = tlm.init_params(cfg, seed=3, device=CPU)
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)
    rules = tsharding.make_rules(cfg, mesh, "train")
    local = tlm.shard_params(params, cfg, rules)
    back = flatten(tlm.gather_params(local, cfg, rules))
    for k, v in flatten(params).items():
        assert back[k].data_ptr() != v.data_ptr()
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


class _FakeMesh:
    """The reference's ``test_rebatch_for_mesh`` stand-in, read by both
    packages (``shape`` for the reference; axis names and sizes for the
    port)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.mesh_dim_names = tuple(shape)

    def size(self, i=None):
        vals = list(self.shape.values())
        return int(np.prod(vals)) if i is None else vals[i]


@pytest.mark.parametrize("shape", [{"data": 8, "model": 4},
                                   {"data": 2, "model": 2},
                                   {"pod": 2, "data": 3, "model": 4},
                                   {"data": 1, "model": 16}])
def test_rebatch_and_batch_shape_check_match_reference(shape):
    m = _FakeMesh(shape)
    cfg_j = jconfigs.get_smoke_config("granite-3-2b")
    cfg_t = tconfigs.get_smoke_config("granite-3-2b")
    for gb in (1, 4, 6, 8, 12, 48, 256):
        for prev in (1, 2, 3, 8):
            assert telastic.rebatch_for_mesh(gb, m, prev) == \
                jelastic.rebatch_for_mesh(gb, m, prev), (gb, prev)
        want = got = None
        try:
            jsharding.batch_shape_check(cfg_j, m, gb, "train")
        except ValueError as e:
            want = str(e)
        try:
            tsharding.batch_shape_check(cfg_t, m, gb, "train")
        except ValueError as e:
            got = str(e)
        assert got == want, gb
    n = telastic.rebatch_for_mesh(256, _FakeMesh({"data": 8, "model": 4}), 8)
    assert (256 // n) % 8 == 0


# ---------------------------------------------------------------------------
# the sharded functions: reference values here, the port on its ranks
# ---------------------------------------------------------------------------

def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _xent_case(V, n_labels, seed):
    logits = _np(seed, 4, 8, V)
    labels = np.random.default_rng(seed + 1).integers(0, n_labels, (4, 8))
    f = lambda lg: jL.sharded_softmax_xent(lg, jnp.asarray(labels), None,
                                           None)
    want = np.asarray(f(jnp.asarray(logits)))
    grad = np.asarray(jax.grad(lambda lg: f(lg).sum())(jnp.asarray(logits)))
    return ({"logits": logits, "labels": labels.astype(np.int64)},
            {"loss": want, "grad": grad})


def _decode_case(window, update_cache, seed=0):
    """The reference's flash-decode shapes: B, S, H, KV, D = 2, 64, 8, 4,
    16, d_model 32, kv_chunk 16."""
    B, S, H, KV, D = 2, 64, 8, 4, 16
    p = jL.init_attention(jax.random.PRNGKey(seed), 32, H, KV, D,
                          jnp.float32)
    x, ck, cv = _np(seed + 1, B, 1, 32), _np(seed + 2, B, S, KV, D), \
        _np(seed + 3, B, S, KV, D)
    pos = np.array([70, 70] if window else [37, 37], np.int32)
    kw = dict(n_heads=H, n_kv=KV, d_head=D, rope_theta=1e4, kv_chunk=16,
              window=window, update_cache=update_cache)
    o, k, v = jL.attention_decode(p, jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(pos), **kw)
    inputs = {"x": x, "ck": ck, "cv": cv, "pos": pos, "kw": json.dumps(kw),
              **{f"p/{k2}": np.asarray(a) for k2, a in p.items()}}
    return inputs, {"o": np.asarray(o), "k": np.asarray(k),
                    "v": np.asarray(v)}


def _moe_case(capacity_factor, sub_experts, seed=4):
    cfg = jmoe.MoEConfig(d_model=32, d_ff=16, n_experts=8 // sub_experts,
                         top_k=2, capacity_factor=capacity_factor,
                         sub_experts=sub_experts)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), cfg,
                                               jnp.float32))
    x = _np(seed + 1, 4, 8, 32)
    jp = jax.tree.map(jnp.asarray, p)
    y, aux = jmoe.moe_forward(jp, jnp.asarray(x), cfg)
    if capacity_factor >= 100:      # nothing drops: the dense oracle too
        want, _ = jmoe.moe_forward_dense_oracle(jp, jnp.asarray(x), cfg)
        np.testing.assert_allclose(np.asarray(y), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    inputs = {"x": x, "cfg": np.array(tuple(cfg), np.float64), **p}
    return inputs, {"y": np.asarray(y), "aux": np.asarray(aux)}


CASES = {
    "xent_v64": ("xent", lambda: _xent_case(64, 64, 0), 1e-5),
    "xent_padded_vocab": ("xent", lambda: _xent_case(256, 250, 2), 1e-5),
    "xent_vocab_not_divided": ("xent", lambda: _xent_case(66, 66, 4), 1e-5),
    "decode": ("flash_decode", lambda: _decode_case(None, True), 1e-5),
    "decode_rolling": ("flash_decode", lambda: _decode_case(64, True), 1e-5),
    "decode_static_memory": ("flash_decode",
                             lambda: _decode_case(None, False), 1e-5),
    "moe_drops": ("moe", lambda: _moe_case(1.0, 1), 1e-5),
    "moe_sub_experts_drops": ("moe", lambda: _moe_case(1.0, 2), 1e-5),
    "moe_no_drops": ("moe", lambda: _moe_case(100.0, 1), 1e-5),
    # the port's own: the collectives and their backward formulas
    "collectives": ("collectives", lambda: ({"seed": np.array(7)}, {
        "fwd_err": np.array(0.0), "adjoint_gap": np.array(0.0)}), 0.0),
}
# the reference's own tolerances for these checks
# (tests/test_sharded.py::test_sharded_xent_and_flash_decode, rtol 1e-5 and
# 1e-4 / atol 1e-5 for the gradient; test_sharded_moe_dispatch 1e-4)
TOLS = {"loss": (1e-5, 1e-6), "grad": (1e-4, 1e-5), "o": (1e-5, 1e-6),
        "k": (1e-5, 1e-6), "v": (1e-5, 1e-6), "y": (1e-4, 1e-4),
        "aux": (1e-5, 1e-6), "fwd_err": (0.0, 1e-12),
        "adjoint_gap": (0.0, 1e-9)}


@functools.lru_cache(maxsize=None)
def _reference(name):
    return CASES[name][1]()


def _check(name, got):
    _, want = _reference(name)
    for k, w in want.items():
        rtol, atol = TOLS[k]
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_functions_on_one_rank(name):
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)
    inputs, _ = _reference(name)
    _check(name, _torch_ranks.CASES[CASES[name][0]](dict(inputs), mesh))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case on four gloo ranks of a (data 2, model 2) mesh, in one
    subprocess; returns each case's outputs."""
    d = tmp_path_factory.mktemp("sharding_ranks")
    entries = []
    for name in sorted(CASES):
        inputs, _ = _reference(name)
        np.savez(d / f"{name}.npz", **inputs)
        entries.append({"name": name, "case": CASES[name][0],
                        "mesh": [[2, 2], ["data", "model"]], "world": 4})
    (d / "cases.json").write_text(json.dumps(entries))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_ranks.py"),
         str(d)], env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return {name: dict(np.load(d / f"{name}.out.npz")) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_functions_on_four_gloo_ranks(four_ranks, name):
    _check(name, four_ranks[name])
