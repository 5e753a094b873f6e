"""PyTorch port, the spans at the CapsNet path's layer boundaries
(``repro_torch.runtime.spans``):

* with no profiler a span is the one shared no-op context and calls no
  ``record_function``;
* under ``torch.profiler`` on the CPU, one serving wave (the software
  pipeline, and the unpipelined arm) and one train step of a tiny CapsNet
  on the torch backend and on the cuda backend's plain versions: no
  program span opens inside another, the
  encoder's ops all sit under ``capsnet.encode`` and none outside it, and
  the trace holds a ``capsnet.route`` a microbatch and a
  ``train.optimizer`` a step.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.caps_benchmarks import CapsConfig
from repro_torch.core.router import RouterSpec
from repro_torch.models import capsnet
from repro_torch.optim import adamw_init
from repro_torch.runtime import spans
from repro_torch.runtime.caps_serve import ServeConfig, make_wave_fn
from repro_torch.runtime.train_loop import make_capsnet_train_step

NAMES = ("capsnet.encode", "capsnet.route", "train.backward",
         "train.optimizer")
N_MICRO, MB = 3, 4
VIEWS = {"aten::unsqueeze", "aten::slice", "aten::select", "aten::view",
         "aten::as_strided"}


@pytest.fixture(scope="module")
def net():
    cfg = CapsConfig("Caps-tiny", "synthetic", MB, 72, 10, 2,
                     caps_channels=2, conv_channels=16)
    return capsnet.CapsNet(cfg, device="cpu", seed=0)


def images(net, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    hw = net.cfg.image_hw
    return torch.rand((n, hw, hw, net.cfg.image_channels), generator=g)


def profiled(fn):
    """(the profiler's events, the program's spans among them counted by
    name) over fn()."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = prof.events()
    return events, dict(collections.Counter(
        e.name for e in events if e.name in NAMES))


def ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def assert_flat(events):
    opened = [e for e in events if e.name in NAMES]
    assert opened
    for e in opened:
        assert not [a.name for a in ancestors(e) if a.name in NAMES], e.name


def children(events, name):
    """The direct children of each instance of span ``name``, by name."""
    return [collections.Counter(c.name for c in e.cpu_children)
            for e in events if e.name == name]


def encoder_ops(net, x):
    """The top-level ops of the encoder stage run on its own."""
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            capsnet.encode_votes(net, x)
    return collections.Counter(e.name for e in prof.events()
                               if e.cpu_parent is None)


def test_with_no_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = spans.span("capsnet.route")
    assert spans.span("train.optimizer") is first
    with first:
        with spans.span("capsnet.encode"):
            pass


def test_under_a_profiler_a_span_is_recorded_and_counted():
    def twice():
        for _ in range(2):
            with spans.span("capsnet.route"):
                torch.ones(2).sum()

    events, counts = profiled(twice)
    assert counts == {"capsnet.route": 2}
    opened = [e for e in events if e.name == "capsnet.route"]
    assert len(opened) == 2
    assert all("aten::sum" in {c.name for c in e.cpu_children}
               for e in opened)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("pipeline", ["software", None])
def test_a_serving_wave_opens_flat_spans_and_a_route_a_microbatch(
        net, pipeline, backend):
    # "cuda" on CPU tensors: the kernel wrappers' plain versions, with the
    # stream cast and the copy of û the card's path makes
    wave = make_wave_fn(net, RouterSpec(backend=backend, iterations=2),
                        ServeConfig(microbatch=MB, n_micro=N_MICRO,
                                    pipeline=pipeline))
    x = images(net, N_MICRO * MB)
    micro = {"images": x.reshape(N_MICRO, MB, *x.shape[1:]),
             "mask": torch.ones(N_MICRO, MB)}
    wave(micro)                   # builds the executor outside the trace
    events, counts = profiled(lambda: wave(micro))
    assert counts == {"capsnet.encode": N_MICRO, "capsnet.route": N_MICRO}
    assert_flat(events)
    # the encoder's ops, each microbatch, under capsnet.encode; the lane
    # mask's multiply (and the views that index the mask) beside them
    alone = encoder_ops(net, x[:MB])
    for got in children(events, "capsnet.encode"):
        extra = got - alone
        assert extra.pop("aten::mul") == 1
        assert set(extra) <= VIEWS
        assert not alone - got
    top = {e.name for e in events if e.cpu_parent is None}
    assert not top & {"aten::conv2d", "aten::relu", "aten::einsum"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_a_train_step_opens_each_phase_once_and_flat(net, backend):
    net = capsnet.CapsNet(net.cfg, device="cpu", seed=1)
    step = make_capsnet_train_step(
        net.cfg, spec=RouterSpec(backend=backend, iterations=2),
        device="cpu")
    opt_state = adamw_init(dict(net.named_parameters()))
    x = images(net, MB, seed=1)
    labels = torch.arange(MB) % net.cfg.num_h_caps
    net, opt_state, _ = step(net, opt_state, x, labels)
    events, counts = profiled(lambda: step(net, opt_state, x, labels))
    assert counts == {name: 1 for name in NAMES}
    assert_flat(events)
    alone = encoder_ops(net, x)
    (got,) = children(events, "capsnet.encode")
    assert got == alone
    top = {e.name for e in events if e.cpu_parent is None}
    assert not top & {"aten::conv2d", "aten::einsum"}
    # clipping and AdamW: their element-wise ops all under train.optimizer
    (opt,) = children(events, "train.optimizer")
    assert opt["aten::sqrt"] >= len(dict(net.named_parameters()))
