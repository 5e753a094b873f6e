"""The PyTorch port stands alone: every module of ``repro_torch``,
``chip_smoke.py`` and the examples' twins (``examples/torch_*.py``) imports
with JAX and the JAX package blocked, no source line imports either, and
the entry points default to the card instead of falling back to the
CPU."""
import glob
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs.caps_benchmarks import smoke_caps
from repro_torch.models.capsnet import CapsNet

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")
CHIP_SMOKE = os.path.join(ROOT, "chip_smoke.py")
EXAMPLES = os.path.join(ROOT, "examples")
# the twins of the six examples, which run on the port alone
EXAMPLE_TWINS = ("torch_distributed_routing", "torch_quickstart",
                 "torch_serve_capsnet", "torch_serve_lm",
                 "torch_train_capsnet", "torch_train_lm")
# the training slice's modules, which both scans must reach
TRAINING_MODULES = ("repro_torch.optim.adamw", "repro_torch.optim.schedule",
                    "repro_torch.checkpoint.ckpt",
                    "repro_torch.runtime.train_loop",
                    "repro_torch.runtime.straggler",
                    "repro_torch.launch.train_capsnet")
# the distribution slice's modules
DISTRIBUTION_MODULES = ("repro_torch.core.distribution",
                        "repro_torch.core.pipeline",
                        "repro_torch.runtime.mesh_utils")
# the LM serving slice's modules
LM_MODULES = ("repro_torch.configs.base", "repro_torch.configs.granite_3_2b",
              "repro_torch.configs.falcon_mamba_7b",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.kernels.ssm_scan.kernel",
              "repro_torch.kernels.ssm_scan.ops",
              "repro_torch.kernels.ssm_scan.ref",
              "repro_torch.models.layers", "repro_torch.models.ssm",
              "repro_torch.models.lm", "repro_torch.runtime.serve_loop",
              "repro_torch.launch.serve")
# the LM training slice's modules
LM_TRAINING_MODULES = ("repro_torch.runtime.compression",
                       "repro_torch.data.synthetic",
                       "repro_torch.launch.train")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _example_twins():
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(EXAMPLES, "torch_*.py")))


def _port_sources():
    files = [CHIP_SMOKE] + [os.path.join(EXAMPLES, f"{name}.py")
                            for name in _example_twins()]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def test_every_module_imports_without_jax():
    modules = _port_modules()
    assert "repro_torch.kernels.routing.kernel" in modules
    assert set(TRAINING_MODULES) <= set(modules)
    assert set(DISTRIBUTION_MODULES) <= set(modules)
    assert set(LM_MODULES) <= set(modules)
    assert set(LM_TRAINING_MODULES) <= set(modules)
    assert len(modules) >= 28
    assert tuple(_example_twins()) == EXAMPLE_TWINS
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}, "
        f"{EXAMPLES!r}]\n"
        f"for name in {modules!r} + ['chip_smoke'] + "
        f"{list(EXAMPLE_TWINS)!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m, mod in sys.modules.items()\n"
        "                if mod is not None and (m in ('jax', 'repro') or\n"
        "                m.startswith(('jax.', 'jaxlib', 'repro.'))))\n"
        "assert not leaked, leaked\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|repro)\b(?!_torch))")


def test_no_source_line_imports_jax_or_the_reference():
    offenders = []
    sources = _port_sources()
    for name in TRAINING_MODULES + DISTRIBUTION_MODULES + LM_MODULES + \
            LM_TRAINING_MODULES:
        rel = name.split(".", 1)[1].replace(".", os.sep) + ".py"
        assert os.path.join(PORT, rel) in sources, rel
    for name in EXAMPLE_TWINS:
        assert os.path.join(EXAMPLES, f"{name}.py") in sources, name
    for path in sources:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if _FORBIDDEN.match(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{i}: "
                                     f"{line.strip()}")
    assert not offenders, offenders
    assert _FORBIDDEN.match("from repro.core import router")
    assert _FORBIDDEN.match("import jax.numpy as jnp")
    assert not _FORBIDDEN.match("from repro_torch.core import router")


def test_capsnet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CapsNet(smoke_caps())
    assert CapsNet(smoke_caps(), device="cpu").device.type == "cpu"


def test_distribution_entry_points_default_to_the_card():
    """The mesh helpers and a sharded router run on the card unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.core.router import RouterSpec, build_router
    from repro_torch.runtime import mesh_utils
    for call in (lambda: mesh_utils.make_mesh((1,), ("vault",)),
                 mesh_utils.default_mesh,
                 lambda: build_router(RouterSpec(), "auto")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
