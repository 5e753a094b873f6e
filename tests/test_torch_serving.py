"""PyTorch port, CapsNet serving (``repro_torch.runtime.caps_serve`` over the
copied ``wave_serve`` core): wave scores against the JAX ``CapsServer``'s
for the same images and weights (≤ 1e-5, predictions equal outside
near-ties), bit-invariant padding, the books invariant in sync and
``serve_forever`` modes, the output guard, and the serving CLI."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.caps_benchmarks import CapsConfig
from repro.core import router as jrouter
from repro.data.synthetic import SyntheticCapsDataset
from repro.models import capsnet as jcapsnet
from repro.runtime import caps_serve as jserve
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.core.router import RouterSpec
from repro_torch.launch import serve_caps as tcli
from repro_torch.runtime import caps_serve as tserve
from repro_torch.runtime import wave_serve as twave

TOL = 1e-5
MARGIN = 1e-4


def tiny_caps() -> CapsConfig:
    """The reference serving tests' config: small enough for many waves."""
    return CapsConfig("Caps-tiny", "synthetic", 8, 72, 10, 2,
                      caps_channels=2, conv_channels=16)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_caps()
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg)
    # non-zero conv biases: a zero-image pad lane has non-zero votes, so
    # padding invariance genuinely depends on the lane mask
    params["primary"]["conv1"]["b"] = params["primary"]["conv1"]["b"] + 0.1
    params["primary"]["caps_conv"]["b"] = (
        params["primary"]["caps_conv"]["b"] + 0.05)
    tcfg = tconfigs.CapsConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    net = convert.capsnet_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    return cfg, params, net, ds


def _wave_pair(setup, backend, serve_cfg):
    cfg, params, net, ds = setup
    jspec = jrouter.RouterSpec(backend="jnp" if backend == "torch"
                               else "pallas", iterations=cfg.routing_iters)
    tspec = RouterSpec(backend=backend, iterations=cfg.routing_iters)
    jwave = jserve.make_wave_fn(params, cfg, jspec, serve_cfg)
    tadapter = tserve.CapsAdapter(net, tspec)
    return jwave, tadapter, tadapter.make_wave_fn(serve_cfg)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_wave_scores_match_reference_server(setup, backend):
    cfg, params, net, ds = setup
    serve_cfg = tserve.ServeConfig(microbatch=4, n_micro=2)
    jwave, tadapter, twave_fn = _wave_pair(setup, backend, serve_cfg)
    images = list(ds.batch(3, 6)["images"])          # a ragged wave: 6 of 8
    packed = tadapter.pack(images, serve_cfg)
    got = twave_fn(packed)
    want = jwave({k: jnp.asarray(v.numpy()) for k, v in packed.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    scores = np.asarray(want).reshape(-1, cfg.num_h_caps)[:6]
    top2 = np.sort(scores, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.any()
    preds = np.array(tadapter.unpack(got, 6))
    assert (preds[clear] == scores.argmax(-1)[clear]).all()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_padding_is_bit_invariant(setup, backend):
    """Masked lanes contribute exactly zero to every cross-lane sum: the
    real lanes' scores are the same bits whatever the padded lanes hold,
    and within 1e-5 of a wave with no padding at all."""
    cfg, params, net, ds = setup
    serve_cfg = tserve.ServeConfig(microbatch=8, n_micro=1)
    _, adapter, wave = _wave_pair(setup, backend, serve_cfg)
    real = list(ds.batch(4, 5)["images"])
    zero_pad = adapter.pack(real, serve_cfg)
    junk_pad = adapter.pack(real, serve_cfg)
    junk = torch.from_numpy(ds.batch(5, 3)["images"])
    junk_pad["images"].view(-1, *adapter.image_shape)[5:] = junk
    a = wave(zero_pad).reshape(-1, cfg.num_h_caps)[:5]
    b = wave(junk_pad).reshape(-1, cfg.num_h_caps)[:5]
    assert torch.equal(a, b)
    one = tserve.ServeConfig(microbatch=5, n_micro=1)
    _, _, wave_one = _wave_pair(setup, backend, one)
    c = wave_one(adapter.pack(real, one)).reshape(-1, cfg.num_h_caps)
    torch.testing.assert_close(a, c, rtol=0, atol=TOL)


def test_pipelined_matches_unpipelined(setup):
    cfg, params, net, ds = setup
    images = list(ds.batch(6, 10)["images"])
    outs = {}
    for pipeline in ("software", None):
        serve_cfg = tserve.ServeConfig(microbatch=4, n_micro=3,
                                       pipeline=pipeline)
        adapter = tserve.CapsAdapter(net, RouterSpec(backend="cuda"))
        outs[pipeline] = adapter.make_wave_fn(serve_cfg)(
            adapter.pack(images, serve_cfg))
    torch.testing.assert_close(outs["software"], outs[None], rtol=0, atol=0)


def _books(server, requests):
    s = tcli.check_books(server, requests)
    assert s["submitted"] == s["completed"] == requests
    assert s["wave_errors"] == s["failed"] == s["guard_trips"] == 0
    return s


@pytest.mark.parametrize("mode", ["sync", "serve_forever"])
def test_books_balance(setup, mode):
    cfg, params, net, ds = setup
    serve_cfg = tserve.ServeConfig(microbatch=4, n_micro=2)
    server = tserve.CapsServer(net, RouterSpec(backend="cuda"), serve_cfg,
                               device="cpu")
    schedule = tcli.arrival_schedule(30, 6.0, seed=1)
    assert len(set(schedule)) > 1 and sum(schedule) == 30
    if mode == "sync":
        done = tcli.run_sync(server, ds, schedule)
    else:
        done = tcli.run_async(server, ds, schedule, 3)
    s = _books(server, 30)
    assert sorted(c.rid for c in done) == list(range(30))
    assert all(0 <= c.pred < cfg.num_h_caps for c in done)
    assert s["p50_latency_s"] is not None


def test_sync_predictions_match_reference_server(setup):
    """Both servers complete the same requests with the same predictions
    (the tiny config's random weights leave no near-ties here)."""
    cfg, params, net, ds = setup
    schedule = [5, 0, 9, 2]
    jserver = jserve.CapsServer(params, cfg, jrouter.RouterSpec(
        iterations=cfg.routing_iters),
        jserve.ServeConfig(microbatch=4, n_micro=2))
    tserver = tserve.CapsServer(net, RouterSpec(
        iterations=cfg.routing_iters),
        tserve.ServeConfig(microbatch=4, n_micro=2), device="cpu")
    jdone = {c.rid: c.pred for c in tcli.run_sync(jserver, ds, schedule)}
    tdone = {c.rid: c.pred for c in tcli.run_sync(tserver, ds, schedule)}
    assert jdone == tdone and len(tdone) == 16


def test_backpressure_shed_and_reject(setup):
    cfg, params, net, ds = setup
    imgs = ds.batch(0, 6)["images"]
    shed = tserve.CapsServer(net, cfg=tserve.ServeConfig(
        microbatch=2, n_micro=1, max_queue=4), device="cpu")
    assert len(shed.submit(imgs)) == 4
    assert shed.metrics.shed == 2
    shed.drain()
    s = shed.metrics.summary()
    assert s["submitted"] == s["completed"] + s["shed"] == 6
    reject = tserve.CapsServer(net, cfg=tserve.ServeConfig(
        microbatch=2, n_micro=1, max_queue=4, overflow="reject"),
        device="cpu")
    with pytest.raises(tserve.QueueFullError):
        reject.submit(imgs)
    assert reject.metrics.submitted == 0 and reject.pending() == 0
    with pytest.raises(ValueError, match="image shape"):
        reject.submit(np.zeros((2, 5, 5, 1), np.float32))


def test_output_guard_reruns_torch_reference(setup):
    cfg, params, net, ds = setup
    serve_cfg = tserve.ServeConfig(microbatch=4, n_micro=1)
    spec = RouterSpec(backend="cuda", iterations=cfg.routing_iters)
    good = tserve.make_wave_fn(net, spec, serve_cfg)

    def poisoned(micro):
        return good(micro) * float("nan")

    server = tserve.CapsServer(net, spec, serve_cfg, device="cpu",
                               wave_fn=poisoned)
    server.submit(ds.batch(1, 6)["images"])
    done = server.drain()
    s = server.metrics.summary()
    assert len(done) == 6 and s["guard_trips"] == 2 and s["failed"] == 0
    reference = tserve.CapsServer(net, RouterSpec(
        iterations=cfg.routing_iters), serve_cfg, device="cpu")
    reference.submit(ds.batch(1, 6)["images"])
    assert [c.pred for c in done] == [c.pred for c in reference.drain()]


def test_finite_takes_tensors_and_arrays():
    adapter = twave.WorkloadAdapter()
    assert adapter.finite(torch.ones(3))
    assert not adapter.finite(torch.tensor([1.0, float("inf")]))
    assert not adapter.finite(np.array([np.nan]))


def test_server_device_is_checked(setup):
    cfg, params, net, ds = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.CapsServer(net)
    # routing_plan="auto" distributes the routing stage over the default
    # mesh (one rank here) and answers as the unsharded server does
    spec = RouterSpec(backend="cuda", iterations=cfg.routing_iters)
    sharded = tserve.CapsServer(net, spec, tserve.ServeConfig(
        microbatch=4, n_micro=2, routing_plan="auto"), device="cpu")
    plain = tserve.CapsServer(net, spec, tserve.ServeConfig(
        microbatch=4, n_micro=2), device="cpu")
    images = list(ds.batch(7, 11)["images"])
    for server in (sharded, plain):
        server.submit(images)
    got, want = sharded.drain(), plain.drain()
    assert [c.pred for c in got] == [c.pred for c in want]
    assert len(got) == 11 and sharded.pending() == 0
    # two_stage needs a mesh with a 2-sized pipe axis, as in the reference
    with pytest.raises(ValueError, match="needs a mesh containing axis"):
        tserve.CapsServer(net, cfg=tserve.ServeConfig(pipeline="two_stage"),
                          device="cpu")


@pytest.mark.parametrize("extra", [[], ["--async"], ["--backend", "torch"]],
                         ids=["sync-cuda", "async-cuda", "sync-torch"])
def test_serve_cli_smoke_on_cpu(extra, capsys):
    s = tcli.main(["--smoke", "--device", "cpu", "--requests", "12",
                   *extra])
    assert s["completed"] == 12 and s["failed"] == 0
    assert "served 12 requests" in capsys.readouterr().out


@pytest.mark.parametrize("extra,where", [
    # the LM serving slices: --model lm and --model moe serve
    pytest.param(["--model", "lm"], "serves", id="extra0-slice 6"),
    pytest.param(["--model", "moe"], "serves", id="extra1-slice 6"),
    # the fleet slice's modes serve, their books balanced
    pytest.param(["--replicas", "2"], "serves", id="extra2-slice 4"),
    pytest.param(["--tenants", "2"], "serves", id="extra3-slice 4"),
    pytest.param(["--slo-ms", "100"], "serves", id="extra4-slice 4"),
    pytest.param(["--chaos"], "serves", id="extra5-slice 4"),
    # the distribution slice's modes: --plan auto serves, and two_stage
    # alone exits with the reference's message (it needs two ranks)
    pytest.param(["--algorithm", "em", "--plan", "auto"], "serves",
                 id="extra6-slice 5"),
    pytest.param(["--plan", "auto"], "serves", id="extra7-slice 5"),
    pytest.param(["--pipeline", "two_stage"], "needs >= 2 ranks",
                 id="extra8-slice 5")])
def test_serve_cli_later_modes_raise(extra, where):
    argv = ["--smoke", "--device", "cpu", *extra]
    if where == "serves":
        s = tcli.main(argv + ["--requests", "12"])
        assert s["completed"] == 12 and s["failed"] == 0
    elif where.startswith("needs"):
        with pytest.raises(SystemExit, match=where):
            tcli.main(argv)
    else:
        with pytest.raises(NotImplementedError, match=where):
            tcli.main(argv)
