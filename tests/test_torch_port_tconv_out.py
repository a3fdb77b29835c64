"""The decoder's one-channel output transposed conv (``ops/tconv_out.py``).

On the CPU the op is ``F.conv_transpose2d`` itself: the decoder's output,
and the gradients of its input, weight and bias, are bit-equal to running
its ``nn.ConvTranspose2d`` modules in turn, in float32 and under CPU bf16
autocast; the decoder keeps its ``state_dict`` keys and the flax transplant
of ``dec7``. The wrapper's refusals are read before any build.

On the card (marked ``cuda``; skipped without one, the kernel has no CPU
mode) the kernel ``csrc/tconv_out.cu`` is held to cuDNN's
``F.conv_transpose2d``:

- bf16 at the flagship's (160, 8, 129, 174), at speccnn8l1_2's C_in 32 and
  at a ragged small shape, channels_last (the decoder's layout) and
  contiguous: bit-equal, with and without the bias. Both sum the exact bf16
  products in f32; the kernel adds each output's in cuDNN's order (channel,
  kernel row, kernel column, each ascending), and any other order rounds
  about 1e-5 of the outputs one ulp apart. Each side's biased output is its
  rounded sum plus the bias, rounded again (cuDNN's order read on the card,
  the kernel's held to it).
- float32 within 1e-5 of cuDNN's largest output with TF32 off; float64
  within 1e-12.
- The op's gradients are bit-equal to autograd's for ``F.conv_transpose2d``
  on the same operands and output gradient (cuDNN's deterministic
  algorithms), also through autocast's casts of float32 leaves.
- A CUDA graph of forward and backward, captured under
  ``set_sync_debug_mode('error')``, replays equal to eager; the decoder's
  gradients under the train step's remat checkpoint equal those without;
  the launch counter counts each forward and each recompute.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from preset_gen_vae_tpu_torch import weights
from preset_gen_vae_tpu_torch.models.decoder import (DecoderCNN, SpectrogramDecoder,
                                                     decoder_tconv_specs)
from preset_gen_vae_tpu_torch.ops import tconv_out as to

SPECCNN = ("speccnn8l1", "speccnn8l1_bn", "speccnn8l1_2", "speccnn8l1_3")


def _operands(shape, dtype=torch.float32, device="cpu", seed=0, bias=True,
              channels_last=False):
    """BN-like inputs (channels_last, as the decoder leaves them, or
    contiguous), and weight and bias drawn as the port initialises a
    transposed conv (uniform +-sqrt(1/fan_in))."""
    rng = np.random.default_rng(seed)
    B, C, H, W = shape
    lim = (1.0 / (C * 25)) ** 0.5
    x = torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.uniform(-lim, lim, (C, 1, 5, 5))).to(device, dtype)
    b = torch.from_numpy(rng.uniform(-lim, lim, (1,))).to(device, dtype) if bias else None
    return x, w, b


def _module_forward(cnn: DecoderCNN, x):
    """The decoder's CNN with every block run as its module (cuDNN for the
    last one on the card)."""
    for name in cnn.names:
        x = getattr(cnn, name)(x)
    return torch.clamp(x.float() if x.dtype == torch.bfloat16 else x, -1.0, 1.0)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("autocast", [False, True], ids=["float32", "bf16_autocast"])
@pytest.mark.parametrize("arch", ["speccnn8l1_bn", "speccnn8l1_2"])
def test_plain_path_equals_the_modules(arch, autocast):
    """The decoder's CNN through the op against its modules run in turn:
    output and every parameter's and the input's gradient bit-equal."""
    torch.manual_seed(0)
    specs = decoder_tconv_specs(arch)
    cnn = DecoderCNN(specs, 64)
    x0 = torch.randn(2, 64, 3, 4)
    g = torch.randn(2, 1, 257, 347)
    got, want = [], []
    n0 = to.LAUNCHES["tconv_out"]
    for fn, out in ((cnn.forward, got), (lambda x: _module_forward(cnn, x), want)):
        x = x0.clone().requires_grad_(True)
        cnn.zero_grad(set_to_none=True)
        ctx = torch.autocast("cpu", dtype=torch.bfloat16) if autocast else contextlib.nullcontext()
        with ctx:
            y = fn(x)
        y.backward(g)
        out += [y.detach(), x.grad, *(p.grad for p in cnn.parameters())]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert to.LAUNCHES["tconv_out"] == n0  # the plain version is no launch


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 9, 12), (1, 32, 5, 7), (3, 3, 1, 1)])
def test_plain_op_equals_the_layer(shape, bias):
    """``conv_transpose_out`` on CPU tensors against an ``nn.ConvTranspose2d``
    holding the same weight and bias: output and the three gradients."""
    x, w, b = _operands(shape, bias=bias)
    layer = nn.ConvTranspose2d(shape[1], 1, 5, 2, 2, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(w)
        if bias:
            layer.bias.copy_(b)
    assert to.takes_geometry(layer)
    g = torch.randn(shape[0], 1, 2 * shape[2] - 1, 2 * shape[3] - 1)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya = to.conv_transpose_out(xa, layer.weight, layer.bias)
    ga = torch.autograd.grad(ya, [xa, *layer.parameters()], g)
    yb = layer(xb)
    gb = torch.autograd.grad(yb, [xb, *layer.parameters()], g)
    assert torch.equal(ya, yb) and all(torch.equal(a, c) for a, c in zip(ga, gb))


@pytest.mark.parametrize("arch", SPECCNN)
def test_every_speccnn8l1_decoder_ends_on_the_kernel_geometry(arch):
    """Each speccnn8l1 decoder's last layer is a bare ``nn.ConvTranspose2d``
    that the kernel takes; none of its other layers is."""
    cnn = SpectrogramDecoder(arch, 16).single_ch_cnn
    last = getattr(cnn, cnn.names[-1])
    assert type(last) is nn.ConvTranspose2d and to.takes_geometry(last)
    assert not any(isinstance(getattr(cnn, n), nn.ConvTranspose2d) for n in cnn.names[:-1])


@pytest.mark.parametrize("change", [dict(out_channels=2), dict(kernel_size=4), dict(stride=1),
                                    dict(padding=1), dict(output_padding=1),
                                    dict(dilation=2)], ids=lambda d: next(iter(d)))
def test_other_geometries_are_not_the_kernels(change):
    kw = dict(in_channels=8, out_channels=1, kernel_size=5, stride=2, padding=2)
    kw.update(change)
    assert not to.takes_geometry(nn.ConvTranspose2d(**kw))


@pytest.mark.parametrize("arch", ["speccnn8l1_bn", "speccnn8l1_2"])
def test_decoder_keeps_its_state_dict_and_flax_leaves(arch):
    """``dec7`` keeps its module type, its ``state_dict`` keys and its flax
    leaves (``weights.py``'s ``_LEAVES`` by module type), and a transplant
    through the flax layout restores it."""
    torch.manual_seed(1)
    dec = SpectrogramDecoder(arch, 16)
    last = dec.single_ch_cnn.names[-1]
    assert type(getattr(dec.single_ch_cnn, last)) is nn.ConvTranspose2d
    keys = [k for k in dec.state_dict() if f".{last}." in k]
    assert keys == [f"single_ch_cnn.{last}.weight", f"single_ch_cnn.{last}.bias"]
    leaves = {k: (coll, path, tf) for k, coll, path, tf in weights.flax_leaves(dec)}
    assert leaves[f"single_ch_cnn.{last}.weight"] == (
        "params", ("single_ch_cnn", last, "kernel"), "tconv_IOHW")
    assert leaves[f"single_ch_cnn.{last}.bias"] == ("params", ("single_ch_cnn", last, "bias"),
                                                    None)
    blank = SpectrogramDecoder(arch, 16)
    weights.load_flax_variables(blank, weights.flax_variables_from_model(dec))
    for k in keys:
        assert torch.equal(blank.state_dict()[k], dec.state_dict()[k])


@pytest.mark.parametrize("case", ["float16", "strided", "weight_shape", "bias_shape",
                                  "mixed_dtypes", "meta_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w, b = _operands((2, 8, 9, 12))
    if case == "float16":
        x, w, b = x.half(), w.half(), b.half()
    elif case == "strided":  # neither contiguous nor channels_last
        x = torch.zeros(2, 8, 9, 24)[..., ::2]
    elif case == "weight_shape":
        w = torch.zeros(8, 1, 4, 4)
    elif case == "bias_shape":
        b = torch.zeros(2)
    elif case == "mixed_dtypes":
        w = w.double()
    if case == "meta_device":
        with pytest.raises(ValueError):
            to.conv_transpose_out(x.to("meta"), w.to("meta"), b.to("meta"))
    else:
        with pytest.raises(ValueError):
            to.launch(x, w, b)  # refused before any build or launch


def test_kernel_build_command_targets_hopper():
    cmd = to.tconv_out_build_command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert to.TCONV_OUT_SOURCE.exists()


# ---------------------------------------------------------------- the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@contextlib.contextmanager
def _cudnn(deterministic=None, tf32=None):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    if deterministic is not None:
        torch.backends.cudnn.deterministic = deterministic
    if tf32 is not None:
        torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("shape,channels_last", [
    ((160, 8, 129, 174), True), ((160, 8, 129, 174), False), ((160, 32, 129, 174), True),
    ((3, 5, 37, 45), True), ((3, 5, 37, 45), False)],
    ids=["flagship", "flagship_contiguous", "cin32", "ragged", "ragged_contiguous"])
def test_kernel_matches_cudnn_in_bf16(shape, channels_last):
    """Bit-equal to cuDNN, with and without the bias."""
    _need_card()
    x, w, b = _operands(shape, torch.bfloat16, "cuda", seed=shape[1],
                        channels_last=channels_last)
    with torch.no_grad():
        got, ref = to.launch(x, w, None), F.conv_transpose2d(x, w, None, 2, 2)
        got_b, ref_b = to.launch(x, w, b), F.conv_transpose2d(x, w, b, 2, 2)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (shape[0], 1, 2 * shape[2] - 1, 2 * shape[3] - 1)
    share = float((got != ref).float().mean())
    share_b = float((got_b != ref_b).float().mean())
    print(f"[tconv_out bf16 {shape} channels_last={channels_last}] share differing from "
          f"cuDNN {share:.3e} without the bias, {share_b:.3e} with it")
    assert torch.equal(got, ref) and torch.equal(got_b, ref_b)
    # the bias after the rounded sum, rounded again: cuDNN's order with aten's
    # bias, and the kernel's
    bias = b.float()
    assert torch.equal(ref_b, (ref.float() + bias).to(torch.bfloat16))
    assert torch.equal(got_b, (got.float() + bias).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)],
                         ids=["float32", "float64"])
def test_kernel_matches_cudnn_in_float(dtype, tol):
    _need_card()
    for shape, channels_last in (((16, 8, 129, 174), True), ((3, 5, 37, 45), False)):
        x, w, b = _operands(shape, dtype, "cuda", channels_last=channels_last)
        with torch.no_grad(), _cudnn(tf32=False):
            got, ref = to.launch(x, w, b), F.conv_transpose2d(x, w, b, 2, 2)
        err = float((got - ref).abs().max() / ref.abs().max())
        print(f"[tconv_out {dtype} {shape}] max|err| / max|ref| {err:.3e}")
        assert err <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("autocast", [False, True], ids=["bf16_operands", "f32_under_autocast"])
def test_gradients_bit_equal_autograds(autocast):
    """Given the same operands and output gradient, the op's three
    gradients are autograd's for ``F.conv_transpose2d``, bit for bit."""
    _need_card()
    dtype = torch.float32 if autocast else torch.bfloat16
    x0, w0, b0 = _operands((16, 8, 129, 174), dtype, "cuda", seed=3, channels_last=True)
    g = torch.randn(16, 1, 257, 347, device="cuda").to(torch.bfloat16)
    grads = []
    for fn in (to.conv_transpose_out, lambda x, w, b: F.conv_transpose2d(x, w, b, 2, 2)):
        x, w, b = (t.detach().clone().requires_grad_(True) for t in (x0, w0, b0))
        ctx = (torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False) if autocast
               else contextlib.nullcontext())
        with _cudnn(deterministic=True), ctx:
            y = fn(x, w, b)
            assert y.dtype == torch.bfloat16
            grads.append(torch.autograd.grad(y, (x, w, b), g))
    assert all(a.dtype == c.dtype and torch.equal(a, c) for a, c in zip(*grads))


@pytest.mark.cuda
def test_graph_capture_replays_eager():
    """Forward and backward captured in a CUDA graph under
    ``set_sync_debug_mode('error')``; a replay on new inputs equals eager."""
    _need_card()
    x0, w0, b0 = _operands((8, 8, 129, 174), torch.bfloat16, "cuda", seed=4, channels_last=True)
    x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
    g = torch.randn(8, 1, 257, 347, device="cuda").to(torch.bfloat16)

    def body():
        y = to.conv_transpose_out(x, w, b)
        return (y, *torch.autograd.grad(y, (x, w, b), g))

    with _cudnn(deterministic=True):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        n0 = to.LAUNCHES["tconv_out"]
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.graph(graph):
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        assert to.LAUNCHES["tconv_out"] == n0 + 1  # the capture's one launch
        x1, w1, b1 = _operands((8, 8, 129, 174), torch.bfloat16, "cuda", seed=5,
                               channels_last=True)
        with torch.no_grad():
            x.copy_(x1), w.copy_(w1), b.copy_(b1)
        graph.replay()
        replayed = [t.clone() for t in outs]
        eager = body()
    torch.cuda.synchronize()
    assert to.LAUNCHES["tconv_out"] == n0 + 2  # a replay is no launch; eager is one
    assert all(torch.equal(a, c) for a, c in zip(replayed, eager))


@pytest.mark.cuda
def test_decoder_under_remat_equals_without():
    """The decoder at full width, one train-mode step's gradients with the
    train step's remat checkpoint (the forward recomputed in the backward,
    its draws kept, running statistics frozen) against without: equal, and
    the kernel launched once more for the recompute."""
    _need_card()
    from preset_gen_vae_tpu_torch.training.train_step import _recompute_contexts

    torch.manual_seed(0)
    dec = SpectrogramDecoder("speccnn8l1_bn", 32).cuda()
    z = torch.randn(4, 32, device="cuda")
    g = torch.randn(4, 1, 257, 347, device="cuda")
    runs = []
    for remat in (False, True):
        dec.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        n0 = to.LAUNCHES["tconv_out"]
        with _cudnn(deterministic=True), torch.autocast("cuda", dtype=torch.bfloat16,
                                                        cache_enabled=False):
            if remat:
                y = torch.utils.checkpoint.checkpoint(
                    dec, z, generator=gen, use_reentrant=False, preserve_rng_state=False,
                    context_fn=lambda: _recompute_contexts(dec))
            else:
                y = dec(z, generator=gen)
        y.backward(g)
        torch.cuda.synchronize()
        runs.append((to.LAUNCHES["tconv_out"] - n0, y.detach(),
                     [p.grad.clone() for p in dec.parameters()]))
    (n_plain, y_plain, g_plain), (n_remat, y_remat, g_remat) = runs
    assert (n_plain, n_remat) == (1, 2)
    assert torch.equal(y_plain, y_remat)
    assert all(torch.equal(a, c) for a, c in zip(g_plain, g_remat))
