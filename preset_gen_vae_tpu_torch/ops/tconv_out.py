"""The decoder's one-channel output transposed convolution, with its
hand-written kernel behind it.

The last layer of the speccnn8l1 decoders (``models/decoder.py``, the bare
``nn.ConvTranspose2d`` of ``single_ch_cnn``) maps C_in channels to one:
kernel 5x5, stride 2, padding 2, no output padding, (B, C_in, H, W) ->
(B, 1, 2H - 1, 2W - 1). The JAX package leaves it to XLA; on the card cuDNN
runs it as a grouped direct backward-data kernel without tensor cores, the
largest kernel of the train step. ``conv_transpose_out`` is the wrapper. A
tensor on the CPU goes through ``plain`` (``F.conv_transpose2d``). A tensor
on the card launches ``csrc/tconv_out.cu`` (built with nvcc at first use,
bound with ctypes) on the operands autocast would hand the convolution, in
the layout the decoder leaves them (channels_last) or contiguous, or raises
on a geometry, dtype or layout the kernel does not take; it never falls
back to cuDNN. Its gradient is ``aten.convolution_backward`` on the
saved operands, what autograd computes for ``F.conv_transpose2d``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _native
from .spectrogram import nvcc_path

# launches of the kernel, counted by its wrapper at the launch
LAUNCHES = {"tconv_out": 0}

KERNEL, STRIDE, PAD = 5, 2, 2  # the geometry csrc/tconv_out.cu is written for
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
TCONV_OUT_SOURCE = _native.REPO_ROOT / "preset_gen_vae_tpu_torch" / "csrc" / "tconv_out.cu"


def takes_geometry(conv: torch.nn.ConvTranspose2d) -> bool:
    """Whether the kernel computes ``conv``: one output channel, kernel 5,
    stride 2, padding 2, dilation 1, no output padding, one group."""
    return (conv.out_channels == 1 and conv.kernel_size == (KERNEL, KERNEL)
            and conv.stride == (STRIDE, STRIDE) and conv.padding == (PAD, PAD)
            and conv.dilation == (1, 1) and conv.output_padding == (0, 0) and conv.groups == 1)


def plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return F.conv_transpose2d(x, weight, bias, STRIDE, PAD)


def conv_transpose_out(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The layer's forward: ``plain`` on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no tconv_out kernel for device {x.device}")
    if torch.is_autocast_enabled("cuda"):  # the casts autocast makes for a convolution
        low = torch.get_autocast_dtype("cuda")
        x, weight, bias = (t.to(low) if t is not None and t.dtype != torch.float64 else t
                           for t in (x, weight, bias))
    return _TConvOut.apply(x, weight, bias)


class _TConvOut(torch.autograd.Function):
    """Forward, the kernel; backward, ``aten.convolution_backward`` on the
    saved operands, as autograd runs it for ``F.conv_transpose2d``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        return launch(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        need = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.needs_input_grad[2] and ctx.bias_sizes is not None]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, ctx.bias_sizes, [STRIDE] * 2, [PAD] * 2, [1, 1], True, [0, 0], 1,
            need)
        return gx, gw, gb


def launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on (B, C, H, W) ``x``, contiguous or channels_last (the
    decoder's layout), a contiguous (C, 1, 5, 5) ``weight`` and (1,) ``bias``
    or None, of one dtype, on one device."""
    ops = [t for t in (x, weight, bias) if t is not None]
    if any(t.dtype != x.dtype or t.device != x.device for t in ops) or x.dtype not in _DTYPES:
        raise ValueError("tconv_out takes bfloat16, float32 or float64 operands of one dtype on "
                         f"one device; got {[(t.dtype, str(t.device)) for t in ops]}")
    if (x.dim() != 4 or min(x.shape) == 0 or weight.shape != (x.shape[1], 1, KERNEL, KERNEL)
            or (bias is not None and bias.shape != (1,)) or x[0].numel() >= 2**31):
        raise ValueError(f"tconv_out takes (B, C, H, W) input of < 2^31 elements an item, (C, 1, "
                         f"{KERNEL}, {KERNEL}) weight and (1,) bias; got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {None if bias is None else tuple(bias.shape)}")
    B, C, H, W = x.shape
    if x.is_contiguous():
        strides = (C * H * W, H * W, W, 1)
    elif x.is_contiguous(memory_format=torch.channels_last):
        strides = (H * W * C, 1, W * C, C)
    else:
        raise ValueError(f"tconv_out takes a contiguous or channels_last input; got strides "
                         f"{x.stride()}")
    if not all(t.is_contiguous() for t in ops[1:]):
        raise ValueError("tconv_out takes a contiguous weight and bias")
    out = torch.empty((B, 1, 2 * H - 1, 2 * W - 1), dtype=x.dtype, device=x.device)
    lib = _tconv_out_library()
    with torch.cuda.device(x.device):  # the launch targets the current device
        err = lib.tconv_out_launch(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, C, H, W, *strides, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tconv_out kernel launch failed: cudaError_t {err}")
    LAUNCHES["tconv_out"] += 1
    return out


def tconv_out_build_command():
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@functools.lru_cache(maxsize=None)
def _tconv_out_library() -> ctypes.CDLL:
    """Builds (first use only) and loads the kernel. Never called at import."""
    lib = ctypes.CDLL(str(_native.build_shared_library(
        "tconv_out", tconv_out_build_command(), [TCONV_OUT_SOURCE])))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tconv_out_launch.restype = i
    lib.tconv_out_launch.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i, i, i, p]
    return lib
