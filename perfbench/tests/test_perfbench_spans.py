"""The readers of the program's spans, on synthetic traces: what each
claims by span, a span's host time and instances rebuilt from the host
segments (and, on the CPU profiler, from the program's own spans), and
nothing read from a trace without program spans (a program that has
none)."""
import pytest
import torch

from perfbench.common import flops, harness, peaks, spans
from perfbench.common import trace as tr

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")


def reader(name):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    metric = next(m for m in bench["per_layer"] if m["name"] == name)
    return harness.load_reader(metric)


def view(trace, counters=None):
    cfg = harness.load_json(harness.BASE / "configs" / "caps-mn1.json")
    return harness.RunView({}, cfg, counters or {}, trace, H100)


def op(name, s, e, host=""):
    return tr.DeviceOp(name, s, e, host)


def wave_host(n_micro):
    """The host segments of a wave of ``n_micro`` microbatches: each
    encoded and routed in its span, the benchmark's code between."""
    events = [(0.0, 1.0, "bench.window"), (0.0, 1.0, "bench.wave")]
    step = 0.9 / n_micro
    for i in range(n_micro):
        t = i * step
        events += [(t, t + 0.3 * step, "capsnet.encode"),
                   (t + 0.1 * step, t + 0.2 * step, "aten::conv2d"),
                   (t + 0.4 * step, t + 0.8 * step, "capsnet.route"),
                   (t + 0.5 * step, t + 0.6 * step, "aten::contiguous")]
    events.append((0.92, 0.95, "aten::linalg_vector_norm"))
    return tr.host_segments(events)


# a wave of two microbatches with the program's spans: encoder ops, the
# router's copy of û and its kernel, and the score's norm outside both
WAVE_OPS = [
    op("implicit_gemm", 0.00, 0.30, "capsnet.encode"),
    op("elementwise_kernel", 0.30, 0.32, "capsnet.encode"),
    op("elementwise_kernel", 0.32, 0.34, "capsnet.route"),
    op("routing_tile_kernel", 0.34, 0.40, "capsnet.route"),
    op("implicit_gemm", 0.40, 0.70, "capsnet.encode"),
    op("elementwise_kernel", 0.70, 0.72, "capsnet.route"),
    op("routing_tile_kernel", 0.72, 0.78, "capsnet.route"),
    op("reduce_kernel", 0.78, 0.80, "aten::linalg_vector_norm")]
WAVE = tr.Trace(0.0, 1.0, WAVE_OPS, wave_host(2))

# the same work as a program without spans launches it
PARENT_WAVE = tr.Trace(0.0, 1.0, [
    op("implicit_gemm", 0.00, 0.30, "aten::conv2d"),
    op("elementwise_kernel", 0.32, 0.34, "aten::contiguous"),
    op("routing_tile_kernel", 0.34, 0.40)])


def test_encode_span_share_claims_what_the_span_launched():
    got = reader("encode_span_share.serve").read(view(WAVE))
    assert got == pytest.approx(100 * 0.62 / 0.80)
    assert reader("encode_span_share.serve").read(view(PARENT_WAVE)) is None
    assert reader("encode_span_share.serve").read(view(None)) is None


def test_route_span_roofline_counts_the_spans_in_the_trace():
    cfg = view(None).config
    bound = flops.routing_bound_s(cfg, 100, 67e12, 3.35e12)
    r = reader("route_span_roofline.serve")
    got = r.read(view(WAVE, {"microbatch": 100}))
    assert got == pytest.approx(100 * bound * 2 / 0.16)
    # the count is the trace's instances of the span, not the benchmark's
    # arithmetic
    four = tr.Trace(0.0, 1.0, WAVE_OPS, wave_host(4))
    assert r.read(view(four, {"microbatch": 100,
                              "trace_routing_calls": 2})) == \
        pytest.approx(2 * got)
    # the parent: no spans in the trace
    assert r.read(view(PARENT_WAVE, {"microbatch": 100})) is None
    no_host = tr.Trace(0.0, 1.0, WAVE_OPS)
    assert r.read(view(no_host, {"microbatch": 100})) is None


# two steps' tails: the backward's last kernel, the optimizer's launches
# with the card idle between them, then the benchmark's code
STEPS_HOST = tr.host_segments([
    (0.0, 1.0, "bench.window"),
    (0.0, 0.5, "bench.step"),
    (0.00, 0.10, "train.backward"),
    (0.10, 0.40, "train.optimizer"),
    (0.12, 0.14, "aten::mul"),
    (0.13, 0.14, "cudaLaunchKernel"),
    (0.20, 0.22, "aten::add"),
    (0.40, 0.45, "aten::detach"),
    (0.5, 1.0, "bench.step"),
    (0.50, 0.60, "train.backward"),
    (0.60, 0.90, "train.optimizer"),
    (0.70, 0.80, "aten::sqrt")])
STEPS = tr.Trace(0.0, 1.0, [
    op("bwd_kernel", 0.00, 0.11, "autograd::engine::evaluate_function"),
    op("mul_kernel", 0.14, 0.15, "train.optimizer"),
    op("add_kernel", 0.22, 0.23, "train.optimizer"),
    op("bwd_kernel", 0.50, 0.61, "autograd::engine::evaluate_function"),
    op("sqrt_kernel", 0.80, 0.81, "train.optimizer")], STEPS_HOST)


def test_host_intervals_rebuild_each_span_from_the_segments():
    got = spans.host_intervals(STEPS, "train.optimizer")
    # the span's own time and its ops'; the op right after the first
    # instance too, with no bare benchmark segment between (the rule's
    # limit: the segments name only the innermost event)
    assert tr.union_s(got) == pytest.approx(0.30 + 0.30 + 0.05)
    assert (0.12, 0.13) in got and (0.13, 0.14) in got
    assert tr.union_s(spans.host_intervals(STEPS, "train.backward")) == \
        pytest.approx(0.20)
    parent = tr.Trace(0.0, 1.0, [], tr.host_segments([
        (0.0, 1.0, "bench.window"), (0.0, 0.5, "bench.step"),
        (0.1, 0.2, "aten::mul")]))
    assert spans.host_intervals(parent, "train.optimizer") == []


def test_host_intervals_end_at_a_bare_benchmark_segment():
    host = tr.host_segments([
        (0.0, 1.0, "bench.window"), (0.0, 0.5, "bench.step"),
        (0.1, 0.2, "train.optimizer"), (0.3, 0.4, "aten::copy_"),
        (0.6, 0.7, "aten::add")])
    t = tr.Trace(0.0, 1.0, [], host)
    assert spans.host_intervals(t, "train.optimizer") == [(0.1, 0.2)]


def test_overlap_is_the_intersection_of_two_unions():
    assert spans.overlap_s([(0, 2), (3, 4)], [(1, 3.5)]) == \
        pytest.approx(1.5)
    assert spans.overlap_s([], [(0, 1)]) == 0.0


def test_optimizer_launches_per_step():
    r = reader("optimizer_launches.train")
    assert spans.instances(STEPS, "train.optimizer") == 2
    assert r.read(view(STEPS)) == pytest.approx(1.5)
    assert r.read(view(tr.Trace(0.0, 1.0, STEPS.device))) is None
    assert r.read(view(tr.Trace(0.0, 1.0, [op("k", 0, 1, "aten::mul")],
                                STEPS_HOST))) is None


def test_optimizer_idle_share_is_idle_time_inside_the_span():
    # idle: 0.11-0.14, 0.15-0.22, 0.23-0.50, 0.61-0.80, 0.81-1.0; inside
    # the optimizer's host time (0.10-0.45, 0.60-0.90): 0.03 + 0.07 + 0.22
    # + 0.19 + 0.09
    got = reader("optimizer_idle_share.train").read(view(STEPS))
    assert got == pytest.approx(100 * 0.60)
    no_spans = tr.Trace(0.0, 1.0, STEPS.device, tr.host_segments([
        (0.0, 1.0, "bench.window"), (0.0, 0.5, "bench.step"),
        (0.12, 0.14, "aten::mul")]))
    assert reader("optimizer_idle_share.train").read(view(no_spans)) is None
    assert reader("optimizer_idle_share.train").read(view(None)) is None


def test_instances_count_openings_not_segments():
    assert spans.instances(WAVE, "capsnet.route") == 2
    assert spans.instances(WAVE, "capsnet.encode") == 2
    assert spans.instances(tr.Trace(0.0, 1.0, [], wave_host(5)),
                           "capsnet.route") == 5
    # one instance split by its ops is one; the benchmark's code between
    # two makes two
    host = tr.host_segments([
        (0.0, 1.0, "bench.window"), (0.0, 1.0, "bench.step"),
        (0.1, 0.4, "train.optimizer"), (0.2, 0.25, "aten::mul"),
        (0.3, 0.35, "aten::add"), (0.5, 0.6, "train.optimizer")])
    assert spans.instances(tr.Trace(0.0, 1.0, [], host),
                           "train.optimizer") == 2
    assert spans.instances(PARENT_WAVE, "capsnet.route") == 0


# a training step's routing: the forward's copy of û and procedure kernel
# under capsnet.route, the backward's kernels under autograd's thread, and
# the same work as a program without spans launches it
def train_trace(spanned, steps=2):
    dev, events = [], [(0.0, 1.0, "bench.window")]
    for i in range(steps):
        t = i / steps
        route = "capsnet.route" if spanned else "aten::contiguous"
        dev += [op("implicit_gemm", t, t + 0.1,
                   "capsnet.encode" if spanned else "aten::conv2d"),
                op("elementwise_kernel", t + 0.10, t + 0.11, route),
                op("routing_tile_kernel", t + 0.11, t + 0.13,
                   route if spanned else ""),
                op("routing_tile_kernel", t + 0.20, t + 0.22,
                   "autograd::engine::evaluate_function: Backward"),
                op("reverse_tile_kernel", t + 0.22, t + 0.25,
                   "autograd::engine::evaluate_function: Backward"),
                op("du_kernel", t + 0.25, t + 0.26,
                   "autograd::engine::evaluate_function: Backward"),
                op("vectorized_elementwise_kernel", t + 0.30, t + 0.31,
                   "train.optimizer" if spanned else "aten::mul")]
        events.append((t, t + 0.5, "bench.step"))
        if spanned:
            events += [(t + 0.01, t + 0.05, "capsnet.encode"),
                       (t + 0.06, t + 0.09, "capsnet.route"),
                       (t + 0.07, t + 0.08, "aten::contiguous"),
                       (t + 0.10, t + 0.12, "train.backward"),
                       (t + 0.13, t + 0.2, "train.optimizer")]
    return tr.Trace(0.0, 1.0, dev, tr.host_segments(events))


def test_route_span_roofline_train_takes_the_span_and_the_backward():
    cfg = view(None).config
    args = (cfg, 100, 67e12, 3.35e12)
    bound = (flops.routing_bound_s(*args)
             + flops.routing_bound_s(*args, backward=True))
    r = reader("route_span_roofline.train")
    counters = {"batch": 100, "trace_steps": 2}
    # per step: the copy 0.01, the forward kernel 0.02, the backward's
    # replay, reverse sweep and dL/dû 0.06
    got = r.read(view(train_trace(True), counters))
    assert got == pytest.approx(100 * bound * 2 / (2 * 0.09))
    # the same as the old reader reads on a program without spans, where
    # the copy launches under aten::contiguous
    old = reader("routing_roofline.train").read(
        view(train_trace(False), counters))
    assert got == pytest.approx(old)
    # the parent: no capsnet.route in the trace
    assert r.read(view(train_trace(False), counters)) is None
    assert r.read(view(None, counters)) is None


def cpu_trace(fn):
    """The ``Trace`` of fn(mark) on the CPU profiler, inside the
    benchmark's window; ``mark(name)`` opens one of the benchmark's
    annotations."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def mark(name):
        return record_function(tr.ANNOTATION + name)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            fn(mark)
    return tr.from_profiler(prof)


def tiny_net(seed=0):
    from repro_torch.configs.caps_benchmarks import CapsConfig
    from repro_torch.models import capsnet
    cfg = CapsConfig("Caps-tiny", "synthetic", 4, 72, 10, 2,
                     caps_channels=2, conv_channels=16)
    return capsnet.CapsNet(cfg, device="cpu", seed=seed)


def tiny_images(net, n):
    g = torch.Generator().manual_seed(0)
    hw = net.cfg.image_hw
    return torch.rand((n, hw, hw, net.cfg.image_channels), generator=g)


@pytest.mark.parametrize("pipeline", ["software", None])
def test_the_programs_wave_gives_a_route_instance_a_microbatch(pipeline):
    from repro_torch.core.router import RouterSpec
    from repro_torch.runtime.caps_serve import ServeConfig, make_wave_fn
    net, n_micro, mb = tiny_net(), 3, 4
    wave = make_wave_fn(net, RouterSpec(backend="cuda", iterations=2),
                        ServeConfig(microbatch=mb, n_micro=n_micro,
                                    pipeline=pipeline))
    x = tiny_images(net, n_micro * mb)
    micro = {"images": x.reshape(n_micro, mb, *x.shape[1:]),
             "mask": torch.ones(n_micro, mb)}
    wave(micro)

    def waves(mark):
        for _ in range(2):
            with mark("wave"):
                wave(micro)

    trace = cpu_trace(waves)
    assert spans.instances(trace, "capsnet.route") == 2 * n_micro
    assert spans.instances(trace, "capsnet.encode") == 2 * n_micro


def test_the_programs_train_step_gives_an_instance_a_step():
    from repro_torch.core.router import RouterSpec
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_capsnet_train_step
    net = tiny_net(seed=1)
    step = make_capsnet_train_step(
        net.cfg, spec=RouterSpec(backend="cuda", iterations=2),
        device="cpu")
    state = [net, adamw_init(dict(net.named_parameters()))]
    x = tiny_images(net, 4)
    labels = torch.arange(4) % net.cfg.num_h_caps

    def steps(mark):
        for _ in range(3):
            with mark("step"):
                state[:2] = step(state[0], state[1], x, labels)[:2]

    trace = cpu_trace(steps)
    for name in ("capsnet.encode", "capsnet.route", "train.backward",
                 "train.optimizer"):
        assert spans.instances(trace, name) == 3, name


def test_the_readers_claim_by_span_in_the_breakdown():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    names = ("encode_span_share.serve", "route_span_roofline.serve",
             "optimizer_launches.train", "route_span_roofline.train")
    claims = tr.Claims()
    for name in names:
        mod = reader(name)
        claims.add(mod.LAYER, mod.KERNELS, mod.OPS)
    assert [claims.layer_of(d) for d in WAVE.device] == [
        "encoder", "encoder", "routing", "routing", "encoder", "routing",
        "routing", "other"]
    assert [claims.layer_of(d) for d in STEPS.device] == [
        "other", "optimizer", "optimizer", "other", "optimizer"]
    layers = {m["name"]: m["layer"] for m in bench["per_layer"]}
    assert layers["encode_span_share.serve"] == layers["encoder_share.serve"]
    assert layers["route_span_roofline.serve"] == \
        layers["routing_roofline.serve"] == \
        layers["route_span_roofline.train"]
    assert layers["optimizer_launches.train"] == \
        layers["optimizer_idle_share.train"]
