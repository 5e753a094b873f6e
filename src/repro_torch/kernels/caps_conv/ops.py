"""The PrimaryCaps convolution's entry point for the encoder.

``caps_conv(..., impl="kernel")`` runs the hand-written kernel
(``kernel.caps_conv``) on the card inside ``CapsConvFunction``, an autograd
Function whose backward is cuDNN's: ``aten.convolution_backward`` on the
saved fp32 input and weight, the call ``F.conv2d``'s own autograd makes, so
for equal inputs and upstream gradient the gradients are ``F.conv2d``'s bit
for bit.  On a shape the kernel does not take it raises; it never falls back
to the library on the card.  On a CPU tensor it runs the plain version.

``impl="library"`` runs ``F.conv2d`` (cuDNN's fp32 call on the card) with
its own autograd.  The caller that owns the choice makes it: serving takes
the default, and ``runtime.train_loop.TRAIN_CAPS_CONV`` says which one a
training step takes and why."""
from __future__ import annotations

import torch

from repro_torch.kernels import fake_mode, plain_mode
from repro_torch.kernels.caps_conv.kernel import caps_conv as _launch
from repro_torch.kernels.caps_conv.kernel import caps_conv_plain

IMPLS = ("kernel", "library")


class CapsConvFunction(torch.autograd.Function):
    """The kernel forward; cuDNN's dgrad, wgrad and bias gradient."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return _launch(x, w, b, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, [w.shape[0]],
            [s, s], [0, 0], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad[:3]))
        return (None if gx is None else gx.permute(0, 2, 3, 1)), gw, gb, None


def caps_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int, impl: str = "kernel") -> torch.Tensor:
    """x (B, H, W, C_in) NHWC, w (C_out, C_in, k, k), b (C_out,) ->
    (B, H_o, W_o, C_out): the convolution at ``stride``, VALID, plus the
    bias, by ``impl`` (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"caps_conv impl {impl!r}: one of {IMPLS}")
    if impl == "library" or (not fake_mode(x) and plain_mode(x)):
        return caps_conv_plain(x, w, b, stride)
    return CapsConvFunction.apply(x, w, b, stride)
