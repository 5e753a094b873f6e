"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage per kernel
family, following the JAX package's layout:

  kernel.py — the CUDA launch wrappers, their plain PyTorch versions, the
              build (``nvcc`` into a shared library) and the ctypes binding;
              sources live in ``repro_torch/csrc/``
  ops.py    — the public routing entry points (tile selection, stream
              dtype, quantisation)
  ref.py    — the eager oracle the kernels are tested against

``plain_mode`` is the counterpart of the reference's
``pallas_interpret_mode``: one probe shared by every kernel wrapper.
``fake_mode`` comes before it: a wrapper given a fake (or meta) tensor —
the dry run's (``launch.dryrun``) — allocates what its launch allocates,
reports its operations and bytes to the active analyses
(``report_kernel``; ``launch.op_analysis``) and launches nothing; it
never runs its plain version.  A wrapper with no fake route raises there
(``refuse_fake``).
"""
from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

HOPPER_MAJOR = 9


# the analyses (``launch.op_analysis.OpAnalysis``) a fake route reports to;
# empty unless one is active
ANALYSES: list = []


def fake_mode(t: torch.Tensor) -> bool:
    """True only for a ``FakeTensor`` or a meta tensor: the kernel wrapper
    then takes its fake route (module docstring)."""
    return isinstance(t, FakeTensor) or t.is_meta


def report_kernel(name: str, flops: float, bytes_moved: float) -> None:
    """A fake route's call: its operations and the bytes it must move
    (inputs read once, outputs written once — the formulas of each
    kernel's bound), to every active analysis."""
    for analysis in ANALYSES:
        analysis.kernel(name, flops, bytes_moved)


def refuse_fake(name: str, t: torch.Tensor) -> None:
    """A wrapper with no fake route (no dry-run cell reaches it) raises on
    a fake tensor instead of running its plain version."""
    if fake_mode(t):
        raise RuntimeError(f"{name} has no fake route: no dry-run cell "
                           "reaches it")


@functools.lru_cache(maxsize=None)   # one entry per device; fixed per card
def _capability(device: torch.device) -> tuple:
    return torch.cuda.get_device_capability(device)


def plain_mode(t: torch.Tensor) -> bool:
    """Which path a kernel wrapper takes for tensor ``t``.

    True for a CPU tensor (the wrapper runs its plain PyTorch version);
    False for a tensor on a Hopper card (capability 9.x: the wrapper
    launches the CUDA kernel).  A CUDA tensor on any other card, or a tensor
    on any other device type, raises: the kernels are built for sm_90a and
    there is no quiet fallback."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"routing kernels run on CUDA (Hopper) or, as "
                           f"their plain versions, on the CPU; got a tensor "
                           f"on {t.device}")
    major, minor = _capability(t.device)
    if major != HOPPER_MAJOR:
        raise RuntimeError(
            f"the routing kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} has capability "
            f"{major}.{minor}")
    return False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry point's
    default) raises when no CUDA device is present instead of dropping to
    the CPU; ``"cpu"`` must be asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         "or 'cpu'")
    return dev


def refuse_grad(name: str, hint: str, *tensors: torch.Tensor) -> None:
    """The LM stack's forward-only kernel wrappers (the two flash-attention
    forwards, the selective scan) record no gradient: a call that would
    need one raises, saying where gradients go, instead of cutting the
    gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only and records no "
                           f"gradient; {hint}")
