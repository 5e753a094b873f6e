"""The metric arithmetic on synthetic traces and counters."""
import pytest

from perfbench.common import flops, harness, peaks
from perfbench.common import trace as tr

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")


def reader(name):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    metric = next(m for m in bench["per_layer"] if m["name"] == name)
    return harness.load_reader(metric)


def config(name="caps-mn1"):
    return harness.load_json(harness.BASE / "configs" / f"{name}.json")


def view(trace, counters, cfg=None):
    return harness.RunView({}, cfg or config(), counters, trace, H100)


def op(name, s, e, host=""):
    return tr.DeviceOp(name, s, e, host)


def test_union_counts_overlaps_once():
    assert tr.union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0
    assert tr.union_s([]) == 0.0


def test_idle_share_is_one_minus_the_union_over_the_window():
    t = tr.Trace(0.0, 10.0, [op("a", -1, 1), op("b", 0.5, 2),
                             op("c", 6, 7), op("d", 9, 12)])
    assert tr.busy_s(t) == 4.0
    assert tr.idle_gaps(t) == [(2, 6), (7, 9)]
    for name in ("idle_share.serve", "idle_share.train"):
        assert reader(name).read(view(t, {})) == pytest.approx(60.0)
    assert reader("idle_share.serve").read(view(None, {})) is None


def test_mfu_is_the_closed_form_operations_over_the_untraced_time_and_peak():
    t = tr.Trace(0.0, 2.0, [op("k", 0, 1)])
    cfg = config()
    pre = {"pre_trace_images": 1000, "pre_trace_s": 3.0}
    got = reader("mfu.serve").read(view(t, pre))
    assert got == pytest.approx(
        100 * 1000 * flops.serve_flops_per_image(cfg) / 3.0 / 67e12)
    got = reader("mfu.train").read(view(t, pre))
    assert got == pytest.approx(
        100 * 1000 * flops.train_flops_per_image(cfg) / 3.0 / 67e12)
    # the traced window's length plays no part
    longer = tr.Trace(0.0, 9.0, [op("k", 0, 1)])
    assert reader("mfu.train").read(view(longer, pre)) == pytest.approx(got)
    # no work or no peaks: nothing, never 0
    for name in ("mfu.serve", "mfu.train"):
        assert reader(name).read(view(t, {"pre_trace_images": 0,
                                          "pre_trace_s": 3.0})) is None
        assert reader(name).read(view(t, {})) is None
        assert reader(name).read(harness.RunView(
            {}, cfg, pre, t, None)) is None


def test_routing_roofline_counts_routing_kernels_only():
    cfg = config()
    k = "void routing_tile_kernel<float, false>(TileArgs)"
    t = tr.Trace(0.0, 1.0, [op(k, 0.0, 0.002), op("routing_reduce_kernel",
                                                  0.002, 0.003),
                            op("sm90_xmma_fprop", 0.003, 0.5)])
    got = reader("routing_roofline.serve").read(view(
        t, {"trace_routing_calls": 10, "microbatch": 100}))
    bound = flops.routing_bound_s(cfg, 100, 67e12, 3.35e12)
    assert got == pytest.approx(100 * bound * 10 / 0.003)
    t2 = tr.Trace(0.0, 1.0, [op(k, 0, 0.001), op("reverse_tile_kernel", 0.001,
                                                 0.002),
                             op("du_kernel", 0.002, 0.004)])
    got = reader("routing_roofline.train").read(view(
        t2, {"trace_steps": 2, "batch": 100}))
    both = bound + flops.routing_bound_s(cfg, 100, 67e12, 3.35e12, True)
    assert got == pytest.approx(100 * both * 2 / 0.004)
    none = tr.Trace(0.0, 1.0, [op("sm90_xmma_fprop", 0, 1)])
    assert reader("routing_roofline.serve").read(view(
        none, {"trace_routing_calls": 10, "microbatch": 100})) is None


def test_encoder_share_claims_by_launching_op():
    t = tr.Trace(0.0, 1.0, [op("conv_kernel", 0.0, 0.4, "aten::conv2d"),
                            op("gemm", 0.4, 0.5, "aten::einsum"),
                            op("routing_tile_kernel", 0.5, 0.7),
                            op("reduce", 0.7, 0.8,
                               "aten::linalg_vector_norm")])
    assert reader("encoder_share.serve").read(view(t, {})) == \
        pytest.approx(100 * 0.5 / 0.8)


def test_breakdown_names_layers_and_other_and_labels_idle_gaps():
    claims = tr.Claims()
    claims.add("routing", r"routing_tile_kernel", "")
    claims.add("encoder", "", r"^aten::conv2d$")
    t = tr.Trace(0.0, 1.0,
                 [op("routing_tile_kernel", 0.1, 0.2),
                  op("implicit_gemm", 0.2, 0.5, "aten::conv2d"),
                  op("renamed_kernel", 0.5, 0.6)],
                 tr.host_segments([(0.0, 1.0, "bench.window"),
                                   (0.0, 0.1, "bench.h2d"),
                                   (0.02, 0.05, "aten::copy_"),
                                   (0.6, 1.0, "bench.wait")]))
    b = tr.breakdown(t, claims)
    names = [n for n, _ in b["device_ops"]]
    assert names == ["encoder:implicit_gemm", "routing:routing_tile_kernel",
                     "other:renamed_kernel"]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"bench.h2d/bench.h2d": pytest.approx(0.1),
                    "bench.wait/bench.wait": pytest.approx(0.4)}


def test_host_segments_are_disjoint_and_innermost():
    seg = tr.host_segments([(0, 10, "bench.window"), (1, 4, "bench.step"),
                            (2, 3, "aten::mul"), (6, 7, "aten::add")])
    assert seg == [(0, 1, "bench.window/bench.window"),
                   (1, 2, "bench.step/bench.step"),
                   (2, 3, "bench.step/aten::mul"),
                   (3, 4, "bench.step/bench.step"),
                   (4, 6, "bench.window/bench.window"),
                   (6, 7, "bench.window/aten::add"),
                   (7, 10, "bench.window/bench.window")]
