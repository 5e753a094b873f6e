"""Each cell's comparison catches the faults its timed path can have: the
harness runs on the CPU past its look for a card, with the program broken
underneath, and ``correct`` comes out false.  (One card, so no exchange
between cards to leave out.)"""
import pytest
import torch

from perfbench.tests import smoke

SERVING = ["caps-smoke.batch"]


def test_sound_runs_are_correct(smoke_base):
    for name in SERVING + ["caps-smoke.train"]:
        line, _, _ = smoke.run_cell(smoke_base, name, seconds=0.5)
        assert line["correct"], (name, line["checks"])


@pytest.mark.parametrize("name", SERVING)
def test_an_answer_altered_where_it_is_produced(smoke_base, monkeypatch,
                                                name):
    from repro_torch.runtime import caps_serve
    real = caps_serve.make_wave_fn

    def altered(*args, **kw):
        wave = real(*args, **kw)

        def run(micro):
            out = wave(micro).clone()
            out[0, 0, 0] += 1e-3
            return out
        return run
    monkeypatch.setattr(caps_serve, "make_wave_fn", altered)
    line, _, _ = smoke.run_cell(smoke_base, name, seconds=0.5)
    assert not line["correct"]


@pytest.mark.parametrize("name", SERVING)
def test_half_the_batch_left_out_of_the_routing_sums(smoke_base,
                                                     monkeypatch, name):
    from repro_torch.kernels.routing import ops
    calls = []

    def half(u_hat, iterations=3, **kw):
        calls.append(1)
        B, L, H, C = u_hat.shape
        b = torch.zeros((L, H))
        for _ in range(iterations):
            c = torch.softmax(b, -1)
            s = torch.einsum("blhc,lh->bhc", u_hat, c)
            n2 = (s * s).sum(-1, keepdim=True)
            v = s * (n2 / (1 + n2)) / torch.sqrt(n2 + 1e-9)
            kept = B // 2      # Eq.4 over half the rows, as a mean x B
            b = b + torch.einsum("blhc,bhc->lh", u_hat[:kept],
                                 v[:kept]) * (B / kept)
        return v
    monkeypatch.setattr(ops, "dynamic_routing_procedure_fused", half)
    line, _, _ = smoke.run_cell(smoke_base, name, seconds=0.5)
    assert calls and not line["correct"]


def test_a_train_step_that_returns_its_state_unchanged(smoke_base,
                                                       monkeypatch):
    from repro_torch.models import capsnet
    from repro_torch.runtime import train_loop
    real = train_loop.make_capsnet_train_step

    def frozen(*args, **kw):
        step = real(*args, **kw)

        def run(net, opt_state, images, labels):
            with torch.no_grad():
                loss, _ = capsnet.loss_fn(net, images, labels,
                                          router=step.router)
            return net, opt_state, {"loss": loss}
        return run
    monkeypatch.setattr(train_loop, "make_capsnet_train_step", frozen)
    line, _, _ = smoke.run_cell(smoke_base, "caps-smoke.train", seconds=0.5)
    assert not line["correct"]
    assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["frozen", "step_count_lost"])
def test_a_train_step_that_goes_wrong_after_the_set_up_steps(
        smoke_base, monkeypatch, fault):
    """The set-up steps are sound and the window's are not: a step that
    stops changing the weights, or one whose optimizer forgets how many
    steps it has taken.  Only the comparison after the window sees it."""
    from repro_torch.models import capsnet
    from repro_torch.runtime import train_loop
    from perfbench.common import harness
    checked = harness.load_module(
        smoke_base / "traffic" / "train.py").CHECKED_STEPS
    real = train_loop.make_capsnet_train_step

    def later(*args, **kw):
        step = real(*args, **kw)
        calls = [0]

        def run(net, opt_state, images, labels):
            calls[0] += 1
            if calls[0] <= checked:
                return step(net, opt_state, images, labels)
            if fault == "frozen":
                with torch.no_grad():
                    loss, _ = capsnet.loss_fn(net, images, labels,
                                              router=step.router)
                return net, opt_state, {"loss": loss}
            net, state, metrics = step(
                net, opt_state._replace(step=torch.zeros_like(
                    opt_state.step)), images, labels)
            return net, state._replace(step=opt_state.step + 1), metrics
        return run
    monkeypatch.setattr(train_loop, "make_capsnet_train_step", later)
    line, _, _ = smoke.run_cell(smoke_base, "caps-smoke.train", seconds=0.5)
    checks = line["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_gap", "grad_gap", "update_gap"))
    assert not line["correct"]
    assert checks["late_update_gap"]["value"] > checks["late_update_gap"][
        "limit"]


def test_half_the_batch_left_out_of_the_loss(smoke_base, monkeypatch):
    from repro_torch.models import capsnet
    real = capsnet.loss_fn

    def half(net, images, labels, *args, **kw):
        kept = images.shape[0] // 2
        return real(net, images[:kept], labels[:kept], *args, **kw)
    monkeypatch.setattr(capsnet, "loss_fn", half)
    line, _, _ = smoke.run_cell(smoke_base, "caps-smoke.train", seconds=0.5)
    assert not line["correct"]
