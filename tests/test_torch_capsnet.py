"""PyTorch port, CapsNet (``repro_torch.models.capsnet``) against the JAX
reference with the reference's weights carried across
(``repro_torch.convert``): PrimaryCaps layout, the crop/tile branch to
num_l_caps, the full forward ({v, class_probs, reconstruction}) to
≤ 1e-5 on both routing backends, and a checkpoint written by
``repro.checkpoint.save_checkpoint`` loading into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.configs.caps_benchmarks import CAPS_BENCHMARKS, CapsConfig, \
    smoke_caps
from repro.core import capsule_layers as JCL
from repro.core import router as jrouter
from repro.data.synthetic import SyntheticCapsDataset
from repro.models import capsnet as jcapsnet
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.core import capsule_layers as TCL
from repro_torch.core.router import RouterSpec
from repro_torch.models import capsnet as tcapsnet

TOL = 1e-5


def _tcfg(cfg: CapsConfig) -> tconfigs.CapsConfig:
    """The port's copy of a reference config, field by field."""
    return tconfigs.CapsConfig(**{f: getattr(cfg, f) for f in
                                  cfg.__dataclass_fields__})


def _setup(cfg: CapsConfig, batch: int, seed: int = 0):
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(seed), cfg)
    # non-zero biases, so a layout slip in b shows up too
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(np.float32) if a.ndim == 1 else a, params)
    params_np = jax.tree.map(np.asarray, params)
    net = convert.capsnet_from_jax(params_np, _tcfg(cfg), device="cpu")
    images = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                                  cfg.num_h_caps).batch(seed, batch)
    return params, net, images


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def test_configs_are_copies():
    assert set(tconfigs.CAPS_BENCHMARKS) == set(CAPS_BENCHMARKS)
    for name, cfg in CAPS_BENCHMARKS.items():
        assert _tcfg(cfg) == tconfigs.CAPS_BENCHMARKS[name]
        assert tconfigs.CAPS_BENCHMARKS[name].spatial == cfg.spatial
    assert _tcfg(smoke_caps()) == tconfigs.smoke_caps()


def test_parameter_names_follow_jax_tree_paths():
    cfg = smoke_caps()
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg)
    paths = {"/".join(str(p.key) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]}
    net = tcapsnet.CapsNet(tconfigs.smoke_caps(), device="cpu")
    assert {n.replace(".", "/") for n, _ in net.named_parameters()} == paths
    assert {"primary.conv1.w", "digit.W", "decoder.fc0.w"} <= \
        {n for n, _ in net.named_parameters()}


def test_conv_weight_layout_hwio_to_oihw():
    params, net, images = _setup(smoke_caps(), 2)
    w_hwio = np.asarray(params["primary"]["conv1"]["w"])
    np.testing.assert_array_equal(net.primary.conv1.w.detach().numpy(),
                                  w_hwio.transpose(3, 2, 0, 1))
    x = images["images"]
    p = params["primary"]["conv1"]
    want = JCL.conv2d(jnp.asarray(x), p["w"], p["b"])
    got = TCL.conv2d(torch.from_numpy(x), net.primary.conv1.w,
                     net.primary.conv1.b)
    _close(got, want)


def test_primary_caps_reshape_layout():
    cfg = smoke_caps()
    params, net, images = _setup(cfg, 3)
    want = jcapsnet.primary_caps(params, jnp.asarray(images["images"]), cfg)
    got = tcapsnet.primary_caps(net, torch.from_numpy(images["images"]))
    assert tuple(got.shape) == (3, cfg.num_l_caps, cfg.l_caps_dim)
    _close(got, want)


@pytest.mark.parametrize("num_l_caps", [100, 50])
def test_crop_and_tile_to_num_l_caps(num_l_caps):
    """6·6·2 = 72 capsules from the conv stack: 100 takes the tile branch
    (as Caps-CF1 does, 2048 -> 2304), 50 the crop."""
    cfg = CapsConfig("Caps-tile", "synthetic", 4, num_l_caps, 10, 2,
                     caps_channels=2, conv_channels=16)
    params, net, images = _setup(cfg, 3)
    x = images["images"]
    want = jcapsnet.primary_caps(params, jnp.asarray(x), cfg)
    got = tcapsnet.primary_caps(net, torch.from_numpy(x))
    _close(got, want)
    want = jcapsnet.forward(params, jnp.asarray(x), cfg)
    got = tcapsnet.forward(net, torch.from_numpy(x))
    for key in ("v", "class_probs", "reconstruction"):
        _close(got[key], want[key])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_matches_reference_smoke(backend):
    cfg = smoke_caps()
    params, net, images = _setup(cfg, 4)
    x = images["images"]
    jspec = jrouter.RouterSpec(backend="jnp" if backend == "torch"
                               else "pallas", iterations=cfg.routing_iters)
    want = jcapsnet.forward(params, jnp.asarray(x), cfg, router=jspec)
    with torch.no_grad():   # the cuda backend's forward kernels need it
        got = net(torch.from_numpy(x),
                  router=RouterSpec(backend=backend,
                                    iterations=cfg.routing_iters))
    for key in ("v", "class_probs", "reconstruction"):
        _close(got[key], want[key])


def test_forward_with_labels_and_margin_loss():
    cfg = smoke_caps()
    params, net, images = _setup(cfg, 4, seed=1)
    x, labels = images["images"], images["labels"]
    want = jcapsnet.forward(params, jnp.asarray(x), cfg,
                            labels=jnp.asarray(labels))
    got = tcapsnet.forward(net, torch.from_numpy(x),
                           labels=torch.from_numpy(labels))
    _close(got["reconstruction"], want["reconstruction"])
    jl = JCL.margin_loss(want["v"], jnp.asarray(labels), cfg.num_h_caps)
    tl = TCL.margin_loss(got["v"], torch.from_numpy(labels), cfg.num_h_caps)
    assert abs(float(tl) - float(jl)) < TOL


def test_forward_matches_reference_caps_mn1_width():
    """Caps-MN1 at its full widths (256 conv channels, L=1152, H=10) with a
    batch of 2."""
    cfg = CAPS_BENCHMARKS["Caps-MN1"]
    params, net, images = _setup(cfg, 2)
    x = images["images"]
    want = jcapsnet.forward(params, jnp.asarray(x), cfg)
    got = tcapsnet.forward(net, torch.from_numpy(x))
    for key in ("v", "class_probs", "reconstruction"):
        _close(got[key], want[key])


def test_jax_checkpoint_loads_into_port(tmp_path):
    cfg = smoke_caps()
    params, net, images = _setup(cfg, 3, seed=2)
    path = save_checkpoint(str(tmp_path), 7, params)
    loaded = convert.load_jax_checkpoint(path, tconfigs.smoke_caps(),
                                         device="cpu")
    for (n, a), (_, b) in zip(net.named_parameters(),
                              loaded.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    x = images["images"]
    want = jcapsnet.forward(params, jnp.asarray(x), cfg)
    got = tcapsnet.forward(loaded, torch.from_numpy(x))
    for key in ("v", "class_probs", "reconstruction"):
        _close(got[key], want[key])


def test_convert_rejects_mismatched_trees():
    cfg = smoke_caps()
    params = jax.tree.map(np.asarray,
                          jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg))
    missing = {k: v for k, v in params.items() if k != "decoder"}
    with pytest.raises(KeyError, match="no leaf"):
        convert.capsnet_from_jax(missing, tconfigs.smoke_caps(), "cpu")
    extra = dict(params, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="no counterpart"):
        convert.capsnet_from_jax(extra, tconfigs.smoke_caps(), "cpu")
    other = tconfigs.smoke_caps().__class__(
        **{**tconfigs.smoke_caps().__dict__, "num_h_caps": 11})
    with pytest.raises(ValueError, match="the port expects"):
        convert.capsnet_from_jax(params, other, "cpu")


def test_random_init_is_seeded_and_device_independent():
    cfg = tconfigs.smoke_caps()
    a = tcapsnet.CapsNet(cfg, device="cpu", seed=3)
    b = tcapsnet.CapsNet(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    c = tcapsnet.CapsNet(cfg, device="cpu", seed=4)
    for (n, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                         b.named_parameters(),
                                         c.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=n)
        if n.endswith(".w") or n.endswith(".W"):
            assert not torch.equal(pa, pc), n
