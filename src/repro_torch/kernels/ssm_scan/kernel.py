"""The Mamba-1 selective scan for Hopper: the launch wrapper and its plain
PyTorch version.

Port of the JAX package's ``repro/kernels/ssm_scan/kernel.py``
(``selective_scan``, ``_ssm_kernel``):

    h_t = exp(dt_t·A) ⊙ h_{t−1} + (dt_t·x_t) ⊗ B_t,   y_t = ⟨h_t, C_t⟩ + D·x_t

with an fp32 (Bt, Din, N) state and y in x's dtype.  The CUDA source is
``repro_torch/csrc/ssm_scan.cu``, built with every other kernel into one
library by ``repro_torch.kernels.cudalib``.  The plain version walks T with
the (Bt, Din, N) state, the kernel's own order of operations.

Unlike the TPU kernel, both take an optional initial state ``h0`` and
return the final state h_T beside y — the serving path keeps h_T as the
prompt's SSM state.  Without ``h0``, y is the TPU kernel's.  ``chunk`` keeps
the reference's interface and its divisibility error; on the card it sets
nothing (the kernel stages 32 steps at a time and takes any T).

The kernel is instantiated at the state sizes ``STATE_DIMS``; on the card
any other N runs through ``scan_padded``.  Below 32, A, B, C and h0 are
zero-padded to the next instantiated N: a padded state starts at 0, gains
dt·x·0 and decays by exp(dt·0), so it stays 0 and adds 0 through C.  Above
32, the states, which are independent, run in chunks of 32 (the last one
padded), each in fp32 without D; the chunks' y are summed, D·x is added
once, and the sum is rounded once to x's dtype (rounding each chunk's bf16
y would cost more than the one bf16 ulp the kernel is held to).

``selective_scan`` runs its plain version for a CPU tensor and launches the
kernel for a tensor on a Hopper card (``repro_torch.kernels.plain_mode``
raises for anything else); ``selective_scan.launches`` counts the calls
that launched the kernel (one a chunk of states).  On a fake tensor (the
dry run's: ``repro_torch.kernels.fake_mode``) it takes the launch path up
to each launch — the same pads, chunks and outputs — and reports the
launch's operations and bytes (``scan_cost``) instead.  Like the reference's Pallas kernel it has no
backward: with grad enabled and an input that requires grad it raises,
pointing to the differentiable chunked scan that training runs
(``models.ssm._chunked_selective_scan``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import (cudalib, fake_mode, plain_mode,
                                 refuse_grad, report_kernel)

# dtype codes shared with ssm_scan.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (4, 8, 16, 32)       # the kernel's instantiations
_GRAD_HINT = ("the reference's Pallas scan has no backward either; "
              "training goes through models.ssm._chunked_selective_scan")


# the kernel's launch constants (csrc/ssm_scan.cu: kChannels, kStates,
# kChunk): 64 channels a block, 8 states a lane (all N when N is less),
# 32-step chunks staged in shared memory two at a time
SCAN_CHANNELS = 64
SCAN_STATES_PER_LANE = 8
SCAN_CHUNK = 32


@dataclass(frozen=True)
class ScanGeometry:
    """The scan kernel's launch at one shape: each channel's N states split
    over ``lanes_per_channel`` neighbouring lanes; ``blocks`` blocks of
    ``threads`` threads, each with ``smem_bytes`` of dynamic shared memory
    (two chunk stages of x, dt, B and C, the chunk's B and C in fp32, and
    its y); ``vector_rows``
    when every block moves its rows in 16-byte copies (Din a multiple of 64
    and rows 16-byte aligned; otherwise the edge blocks copy elements)."""
    lanes_per_channel: int
    threads: int
    blocks: int
    smem_bytes: int
    vector_rows: bool


def launch_state_dims(N: int) -> list:
    """The instantiated state sizes ``scan_padded`` runs N states at, one a
    launch."""
    top = STATE_DIMS[-1]
    parts = [N] if N <= top else [min(top, N - lo) for lo in range(0, N, top)]
    return [next(n for n in STATE_DIMS if n >= p) for p in parts]


def scan_padded(callee, x, dt, A, B, C, D, h0=None):
    """``callee(x, dt, A, B, C, D, h0) -> (y, h_T)`` at state sizes the
    kernel instantiates (module docstring): N itself, zero-padded to the
    next entry of ``STATE_DIMS`` below 32, chunks of 32 above."""
    N = A.shape[1]
    if N in STATE_DIMS:
        return callee(x, dt, A, B, C, D, h0)
    top = STATE_DIMS[-1]
    if N < top:
        Np = next(n for n in STATE_DIMS if n > N)

        def pad(t):
            return None if t is None else \
                torch.nn.functional.pad(t, (0, Np - N))
        y, h = callee(x, dt, pad(A), pad(B), pad(C), D, pad(h0))
        return y, h[..., :N].contiguous()
    xf, Bf, Cf = x.float(), B.float(), C.float()
    no_d = torch.zeros_like(D)
    ys, hs = [], []
    for lo in range(0, N, top):
        part = slice(lo, lo + top)
        y, h = scan_padded(
            callee, xf, dt, A[:, part].contiguous(),
            Bf[..., part].contiguous(), Cf[..., part].contiguous(), no_d,
            None if h0 is None else h0[..., part].contiguous())
        ys.append(y)
        hs.append(h)
    y = torch.stack(ys).sum(0) + D * xf
    return y.to(x.dtype), torch.cat(hs, dim=-1)


def scan_geometry(Bt: int, Din: int, N: int,
                  dtype: torch.dtype) -> ScanGeometry:
    """The launch ``ssm_scan.cu`` makes for x of ``dtype`` (fp32 or bf16),
    (Bt, ·, Din) and N states; raises for an N it has no instantiation
    for."""
    if N not in STATE_DIMS:
        raise ValueError(f"the kernel takes state sizes {STATE_DIMS}; got "
                         f"{N}")
    item = dtype.itemsize
    lanes = N // min(N, SCAN_STATES_PER_LANE)
    stage = SCAN_CHUNK * (SCAN_CHANNELS * (item + 4) + 2 * N * item)
    return ScanGeometry(
        lanes_per_channel=lanes, threads=SCAN_CHANNELS * lanes,
        blocks=-(-Din // SCAN_CHANNELS) * Bt,
        smem_bytes=(2 * stage + SCAN_CHUNK * 2 * N * 4
                    + SCAN_CHUNK * SCAN_CHANNELS * item),
        vector_rows=Din % SCAN_CHANNELS == 0 and (Din * item) % 16 == 0)


def _check_args(x, dt, A, B, C, D, chunk: int, h0) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be (Bt, T, Din); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    Bt, T, Din = x.shape
    if A.dim() != 2 or A.shape[0] != Din:
        raise ValueError(f"A must be (Din={Din}, N); got {tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if tuple(t.shape) != (Bt, T, N):
            raise ValueError(f"{name} must be {(Bt, T, N)}; got "
                             f"{tuple(t.shape)}")
    if tuple(D.shape) != (Din,):
        raise ValueError(f"D must be ({Din},); got {tuple(D.shape)}")
    if h0 is not None and tuple(h0.shape) != (Bt, Din, N):
        raise ValueError(f"h0 must be {(Bt, Din, N)}; got "
                         f"{tuple(h0.shape)}")
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")


def selective_scan_plain(x, dt, A, B, C, D, *, chunk: int = 64,
                         h0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``selective_scan``: one step of the recurrence per
    time step on the (Bt, Din, N) fp32 state."""
    _check_args(x, dt, A, B, C, D, chunk, h0)
    Bt, T, Din = x.shape
    N = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf, Df = A.float(), B.float(), C.float(), D.float()
    h = (torch.zeros(Bt, Din, N, device=x.device) if h0 is None
         else h0.float().clone())
    y = torch.empty(Bt, T, Din, device=x.device)
    for t in range(T):
        a = torch.exp(dtf[:, t, :, None] * Af)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1) + Df * xf[:, t]
    return y.to(x.dtype), h


def selective_scan(x, dt, A, B, C, D, *, chunk: int = 64,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bt, T, Din); A: (Din, N); B, C: (Bt, T, N); D: (Din,); h0:
    optional (Bt, Din, N).  x, B and C share one dtype (fp32 or bf16); dt,
    A, D and h0 are fp32.  Returns (y (Bt, T, Din) in x's dtype, h_T (Bt,
    Din, N) fp32)."""
    refuse_grad("selective_scan", _GRAD_HINT,
                *(t for t in (x, dt, A, B, C, D, h0) if t is not None))
    if not fake_mode(x) and plain_mode(x):
        return selective_scan_plain(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    _check_args(x, dt, A, B, C, D, chunk, h0)
    ins = [x, dt, A, B, C, D] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in ins):
        raise ValueError("selective_scan's inputs must lie on one device")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise ValueError(f"the kernel takes x, B, C of one dtype, fp32 or "
                         f"bf16; got {x.dtype}, {B.dtype}, {C.dtype}")
    fp32 = [dt, A, D] + ([h0] if h0 is not None else [])
    if any(t.dtype != torch.float32 for t in fp32):
        raise ValueError("the kernel takes dt, A, D and h0 in fp32")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("selective_scan needs contiguous inputs")
    return scan_padded(_launch, x, dt, A, B, C, D, h0)


def scan_cost(x, dt, A, B, C, D, h0) -> tuple:
    """(operations, bytes) of one launch: per (t, channel, state) dt·A,
    exp, a·h, u·B, +, h·C, + and per (t, channel) dt·x, D·x, +; the
    inputs read once, y and the fp32 h_T written once."""
    Bt, T, Din = x.shape
    ins = [x, dt, A, B, C, D] + ([h0] if h0 is not None else [])
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + x.numel() * x.element_size() + Bt * Din * A.shape[1] * 4
    return Bt * T * Din * (7 * A.shape[1] + 3), nbytes


def _launch(x, dt, A, B, C, D, h0):
    Bt, T, Din = x.shape
    N = A.shape[1]
    scan_geometry(Bt, Din, N, x.dtype)
    y = torch.empty_like(x)
    h_T = torch.empty(Bt, Din, N, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, (h_T.copy_(h0) if h0 is not None else h_T.zero_())
    if fake_mode(x):
        report_kernel("selective_scan", *scan_cost(x, dt, A, B, C, D, h0))
        return y, h_T
    lib = cudalib.build()
    err = lib.selective_scan_fwd(
        cudalib.ptr(x), cudalib.ptr(dt), cudalib.ptr(A), cudalib.ptr(B),
        cudalib.ptr(C), cudalib.ptr(D), cudalib.ptr(h0), cudalib.ptr(y),
        cudalib.ptr(h_T), _DTYPE_CODE[x.dtype], Bt, T, Din, N,
        cudalib.stream(x.device))
    cudalib.check(err)
    selective_scan.launches += 1
    return y, h_T


selective_scan.launches = 0
