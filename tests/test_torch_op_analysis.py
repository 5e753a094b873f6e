"""PyTorch port, the op-level analysis (``launch/op_analysis.py``, the
counterpart of the JAX package's ``launch/hlo_analysis.py``) and the
kernel wrappers' fake routes, held to the reference's tests of
``hlo_analysis``:

* products in a loop count once a trip, by ``torch.utils.flop_counter``'s
  formulas (equal to ``FlopCounterMode`` on real tensors);
* each collective kind's link bytes at group sizes 2 and 16 on a fake
  process group (``hlo_analysis``'s formulas), in a subprocess;
* bf16 and int8 byte counts, views and allocations moving nothing;
* the memory tracker's peak and its split;
* each kernel wrapper on a fake tensor reports its kernel once a call with
  the formulas of its bound, allocates what its launch allocates, and
  never runs its plain version; on a real CPU tensor it runs its plain
  version and reports nothing; the EM and fast-math wrappers, which no
  dry-run cell reaches, raise;
* the private torch API the dry run rests on (the fake process group, the
  fake mode's constant folding) behaves as the dry run expects;
* ``OpStats.as_dict`` keeps ``HloStats.as_dict``'s keys.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels as tkernels
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.routing import kernel as rk
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import LINK_FACTOR, OpAnalysis, OpStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matmuls(x, ws):
    for w in ws:
        x = torch.relu(x @ w)
    return x


def test_three_matmuls_in_a_loop_count_three_times():
    with FakeTensorMode():
        x = torch.empty(64, 128)
        ws = [torch.empty(128, 128) for _ in range(3)]
        with OpAnalysis() as a:
            a.arguments(x, ws)
            a.outputs(_matmuls(x, ws))
    s = a.stats
    assert s.product_flops == 3 * 2 * 64 * 128 * 128
    # three relus, one a result element each
    assert s.flops == s.product_flops + 3 * 64 * 128
    assert s.by_source["aten.mm"][0] == s.product_flops
    xr = torch.randn(64, 128, requires_grad=True)
    wr = [torch.randn(128, 128, requires_grad=True) for _ in range(3)]
    with FlopCounterMode(display=False) as fc:
        y = _matmuls(xr, wr).sum()
        torch.autograd.grad(y, [xr] + wr)
    with FakeTensorMode():
        x = torch.empty(64, 128, requires_grad=True)
        ws = [torch.empty(128, 128, requires_grad=True) for _ in range(3)]
        with OpAnalysis() as a:
            y = _matmuls(x, ws).sum()
            torch.autograd.grad(y, [x] + ws)
    assert a.stats.product_flops == fc.get_total_flops() == 3 * 3 * (
        2 * 64 * 128 * 128)


_COLLECTIVES = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.runtime import mesh_utils
g = int(sys.argv[1])
out = {}
with fake_process_group(0, g):
    mesh = mesh_utils.make_mesh((g,), ("x",), device="cpu")
    with FakeTensorMode():
        x = torch.empty(4, 32)          # 512 bytes fp32
        h = torch.empty(4, 32, dtype=torch.bfloat16)
        cases = {
            "psum": lambda: mesh_utils.psum(x, "x", mesh=mesh),
            "pmax": lambda: mesh_utils.pmax(h, "x", mesh=mesh),
            "psum_scatter": lambda: mesh_utils.psum_scatter(
                torch.empty(4 * g, 32), "x", 0, mesh=mesh),
            "all_gather": lambda: mesh_utils.all_gather(x, "x", 0,
                                                        mesh=mesh),
            "broadcast": lambda: mesh_utils.shard_call(
                lambda t: mesh_utils.broadcast(t, "x", 0), mesh,
                (None,), None)(x),
            "all_reduce_": lambda: mesh_utils.all_reduce_(
                x, mesh.get_group("x")),
        }
        for name, fn in cases.items():
            with OpAnalysis() as a:
                fn()
            out[name] = {"by_kind": dict(a.stats.collective_by_kind),
                         "calls": dict(a.stats.collective_calls)}
print(json.dumps(out))
"""


@pytest.mark.parametrize("g", [2, 16])
def test_collective_bytes_by_kind_on_a_fake_group(g):
    proc = subprocess.run(
        [sys.executable, "-c", _COLLECTIVES, str(g)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ar = 2.0 * (g - 1) / g
    want = {
        "psum": {"all-reduce": ar * 512},
        "pmax": {"all-reduce": ar * 256},                  # bf16
        "psum_scatter": {"all-reduce": ar * 512 * g},      # psum, then a block
        "all_gather": {"all-gather": (g - 1) / g * 512 * g},  # the gathered
        "broadcast": {"broadcast": (g - 1) / g * 512},
        "all_reduce_": {"all-reduce": ar * 512},
    }
    for name, kinds in want.items():
        assert out[name]["by_kind"] == pytest.approx(kinds), name
        assert out[name]["calls"] == {k: 1 for k in kinds}, name


def test_link_factors_are_the_references():
    from repro.launch import hlo_analysis  # noqa: F401 (formulas in its doc)
    for g in (2, 16):
        assert LINK_FACTOR["all-reduce"](g) == 2.0 * (g - 1) / g
        assert LINK_FACTOR["all-gather"](g) == (g - 1) / g
        assert LINK_FACTOR["reduce-scatter"](g) == float(g - 1)
        assert LINK_FACTOR["all-to-all"](g) == (g - 1) / g
        assert LINK_FACTOR["collective-permute"](g) == 1.0


@pytest.mark.parametrize("dtype,item", [(torch.bfloat16, 2),
                                        (torch.int8, 1)])
def test_byte_counts_by_dtype(dtype, item):
    n = 1000
    with FakeTensorMode():
        a = torch.empty(n, dtype=dtype)
        b = torch.empty(n, dtype=dtype)
        with OpAnalysis() as an:
            c = a + b                           # 2 operands + result
        assert an.stats.hbm_bytes == 3 * n * item
        with OpAnalysis() as an:
            c.view(10, 100).t()[:5].unsqueeze(0)    # views: nothing moved
            torch.empty(n, dtype=dtype)             # an allocation: none
        assert an.stats.hbm_bytes == 0
        with OpAnalysis() as an:
            torch.empty(n).to(dtype)                # fp32 read, dtype write
        assert an.stats.hbm_bytes == n * 4 + n * item
        with OpAnalysis() as an:
            c.zero_()                               # a fill writes only
        assert an.stats.hbm_bytes == n * item


def test_memory_peak_and_its_split():
    with FakeTensorMode():
        x = torch.empty(1024)                   # 4 KiB argument
        with OpAnalysis() as a:
            a.arguments(x)
            t = x * 2                           # 4 KiB temporary
            y = (t + 1).sum()                   # another, then a scalar
            del t
            x.add_(1)                           # in place: the argument
            a.outputs(x, y)
    m = a.memory()
    assert m["argument_bytes"] == 4096
    assert m["alias_bytes"] == 4096             # x is returned, updated
    assert m["output_bytes"] == 4096 + 512      # the scalar's block
    # x, t and t + 1 live while the sum's scalar is made
    assert m["peak_bytes_per_device"] == 3 * 4096 + 512
    assert m["peak_bytes_per_device"] == (m["argument_bytes"]
                                          + m["temp_bytes"]
                                          + m["output_bytes"]
                                          - m["alias_bytes"])


def _flash_args(device_fake: bool, dtype=torch.bfloat16):
    B, Hq, Hkv, S, D = 1, 4, 2, 96, 80     # D = 80 runs zero-padded to 96
    mk = (lambda *s, dtype=dtype: torch.empty(*s, dtype=dtype)) \
        if device_fake else \
        (lambda *s, dtype=dtype: torch.randn(
            *s, generator=torch.Generator().manual_seed(len(s))).to(dtype))
    q, o, do = (mk(B, Hq, S, D) for _ in range(3))
    k, v = (mk(B, Hkv, S, D) for _ in range(2))
    lse = mk(B, Hq, S, dtype=torch.float32)
    return q, k, v, o, lse, do


def _routing_args(fake: bool):
    B, L, H, C = 4, 32, 5, 8
    mk = torch.empty if fake else (lambda *s: torch.rand(*s) * 0.1)
    return {"u": mk(B, L, H, C), "b": mk(L, H), "v": mk(B, H, C),
            "s": mk(B, H, C), "g": mk(B, H, C)}


def _scan_args(fake: bool):
    Bt, T, Din, N = 1, 64, 16, 12         # N = 12 runs padded to 16
    mk = torch.empty if fake else (lambda *s: torch.rand(*s) * 0.1)
    return (mk(Bt, T, Din), mk(Bt, T, Din), -mk(Din, N), mk(Bt, T, N),
            mk(Bt, T, N), mk(Din))


# name -> (wrapper, plain version's name on its module, call(args), args,
#          the kernel's (flops, bytes) for the args)
def _calls():
    def fl(args, kind, causal=True):
        q, k = args[0], args[1]
        return fk.attention_cost(kind, q, k, causal, None)
    return {
        "flash_attention": (
            fk, "flash_attention_plain",
            lambda a: fk.flash_attention(*a[:3]), _flash_args,
            lambda a: fl(a, "fwd")),
        "flash_attention_fwd_lse": (
            fk, "flash_attention_fwd_lse_plain",
            lambda a: fk.flash_attention_fwd_lse(*a[:3], causal=False),
            _flash_args, lambda a: fl(a, "fwd_lse", causal=False)),
        "flash_attention_bwd": (
            fk, "flash_attention_bwd_plain",
            lambda a: fk.flash_attention_bwd(*a), _flash_args,
            lambda a: fl(a, "bwd")),
        "selective_scan": (
            sk, "selective_scan_plain", lambda a: sk.selective_scan(*a),
            _scan_args, lambda a: sk.scan_cost(
                a[0], a[1], torch.empty(16, 16), a[3].new_empty(1, 64, 16),
                a[4].new_empty(1, 64, 16), a[5], None)),
        "routing_iteration_fused": (
            rk, "routing_iteration_fused_plain",
            lambda a: rk.routing_iteration_fused(a["u"], a["b"], a["v"],
                                                 l_tile=16),
            _routing_args, lambda a: rk.routing_cost("iteration", a["u"])),
        "routing_procedure_fused": (
            rk, "routing_procedure_fused_plain",
            lambda a: rk.routing_procedure_fused(a["u"], iterations=3,
                                                 l_tile=16),
            _routing_args,
            lambda a: rk.routing_cost("procedure", a["u"], 3)),
        "routing_procedure_bwd": (
            rk, "routing_procedure_bwd_plain",
            lambda a: rk.routing_procedure_bwd(a["u"], a["g"], iterations=3,
                                               l_tile=16),
            _routing_args, lambda a: rk.routing_cost("bwd", a["u"], 3)),
        "routing_stage_votes": (
            rk, "routing_stage_votes_plain",
            lambda a: rk.routing_stage_votes(a["u"], a["b"], l_tile=16),
            _routing_args, lambda a: rk.routing_cost("votes", a["u"])),
        "routing_stage_update": (
            rk, "routing_stage_update_plain",
            lambda a: rk.routing_stage_update(a["u"], a["s"], l_tile=16),
            _routing_args, lambda a: rk.routing_cost("update", a["u"])),
        "routing_stage_update_fold": (
            rk, "routing_stage_update_fold_plain",
            lambda a: rk.routing_stage_update_fold(a["u"], a["s"], a["b"],
                                                   l_tile=16),
            _routing_args, lambda a: rk.routing_cost("fold", a["u"])),
    }


KERNELS = sorted(_calls())


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("name", KERNELS)
def test_fake_route_reports_once_a_call_and_never_runs_the_plain_version(
        name, monkeypatch):
    module, plain_name, call, make, cost = _calls()[name]
    plain = getattr(module, plain_name)
    ran = []

    def spy(*a, **k):
        ran.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(module, plain_name, spy)
    wrapper = getattr(module, name)
    launches = wrapper.launches
    # a real CPU tensor: the plain version, no report
    real_args = make(False)
    with OpAnalysis() as a:
        want = call(real_args)
    assert ran and not a.stats.kernels
    ran.clear()
    # a fake tensor: one report, the plain version never runs
    with FakeTensorMode():
        args = make(True)
        with OpAnalysis() as a:
            got = call(args)
            call(args)
        flops, nbytes = cost(args)
    assert not ran
    assert a.stats.kernels[name] == {"calls": 2, "flops": 2 * flops,
                                     "bytes": 2 * nbytes}
    assert flops > 0 and nbytes > 0
    assert _shapes(got) == _shapes(want)
    assert wrapper.launches == launches        # nothing was launched


def test_fake_routes_allocate_what_their_launch_allocates():
    """The routing backward's launch allocates its replay's and reverse
    sweep's fp32 buffers through torch: the fake route's peak holds
    them."""
    B, L, H, C, T = 4, 32, 5, 8, 3
    with FakeTensorMode():
        u = torch.empty(B, L, H, C)
        g = torch.empty(B, H, C)
        with OpAnalysis() as a:
            a.arguments(u, g)
            a.outputs(rk.routing_procedure_bwd(u, g, iterations=T,
                                               l_tile=16))
    geo = rk._check_kernel_limits(torch.empty(B, L, H, C, device="meta"),
                                  16)
    blocks = ([B * L * H * C * 4, L * H * 4, L * H * 4,   # du, b, gb
               4 * geo.slots * B * H * C]                 # partial
              + [T * L * H * 4] * 2                       # c_all, gb_all
              + [T * B * H * C * 4] * 3)                  # s, vp, gs
    held = sum(-(-n // 512) * 512 for n in blocks)
    assert a.memory()["peak_bytes_per_device"] == \
        a.memory()["argument_bytes"] + held


@pytest.mark.parametrize("name", ["em_stage_stats", "em_stage_estep",
                                  "fastmath_2d"])
def test_wrappers_without_a_fake_route_raise(name):
    from repro_torch.kernels.fastmath import kernel as fmk
    with FakeTensorMode():
        v = torch.empty(2, 16, 3, 4)
        call = {
            "em_stage_stats": lambda: rk.em_stage_stats(
                v, torch.empty(2, 16, 3), torch.empty(2, 16), l_tile=16),
            "em_stage_estep": lambda: rk.em_stage_estep(
                v, torch.empty(2, 3, 4), torch.empty(2, 3, 4),
                torch.empty(2, 3), l_tile=16),
            "fastmath_2d": lambda: fmk.fastmath_2d(torch.empty(256, 512),
                                                   op="exp"),
        }[name]
        with pytest.raises(RuntimeError, match=f"{name} has no fake route"):
            call()


def test_fake_mode_probe():
    assert not tkernels.fake_mode(torch.empty(2))
    assert tkernels.fake_mode(torch.empty(2, device="meta"))
    with FakeTensorMode():
        assert tkernels.fake_mode(torch.empty(2))


def test_private_torch_api_the_dry_run_rests_on():
    """The fake process group, and the fake mode's constants: a (B,)
    position keeps its value through views only while the mode folds
    constants of B elements (``dryrun.constants_up_to``)."""
    from torch._subclasses import fake_tensor
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert callable(FakeStore) and fake_tensor.CONSTANT_NUMEL_LIMIT == 1
    mode = FakeTensorMode()
    pos = mode.fake_tensor_converter.from_real_tensor(
        mode, torch.full((4,), 4095, dtype=torch.int32), make_constant=True)
    with mode:
        with dryrun.constants_up_to(4):
            _ = pos[:, None]                   # a view of 4 elements
            assert int(pos[:1][0] - 2048) == 2047
        assert fake_tensor.CONSTANT_NUMEL_LIMIT == 1
        _ = pos[:, None]                       # the default drops it
        with pytest.raises(DataDependentOutputException):
            int(pos[:1][0])


def test_as_dict_keeps_the_reference_keys():
    from repro.launch import hlo_analysis
    ref = set(hlo_analysis.HloStats().as_dict())
    got = set(OpStats().as_dict())
    # an XLA-on-CPU float normalisation correction, with no counterpart
    assert ref - got == {"collective_bytes_bf16eq"}
    assert got - ref == {"product_flops", "collective_calls", "kernels"}
