"""The denoiser's gated residual stack: CUDA kernel and plain version.

Counterpart of `mixgantts_tpu/ops/pallas.py` (`fused_residual_stack`,
`stack_denoiser_params`).  Per block (`models/denoiser.ResidualBlock`):

    y0 = x + step_proj;  y = y0 + cond @ Wc + bc      (zero outside [0, T))
    z  = conv_k3(y) -> g = sigmoid(z[:, :C]) * tanh(z[:, C:])
    o  = g @ Wo + bo;  x' = (o[:, :C] + y0) / sqrt(2);  skip += o[:, C:]

The step and conditioner projections of every layer are computed up front
with two matrix products; the L layers then run in `csrc/denoiser_stack.cu`
(one launch per layer) for CUDA tensors, or in `fused_residual_stack_plain`
for CPU tensors.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from . import cuda_build


def stack_denoiser_params(denoiser):
    """A port `models.denoiser.Denoiser` -> stacked per-layer tensors in the
    JAX package's layout: conv_w [L, 3, C, 2C], conv_b [L, 2C],
    cond_w [L, Hc, C], cond_b [L, C], step_w [L, C, C], out_w [L, C, 2C],
    out_b [L, 2C]."""
    layers = list(denoiser.residual_layers)

    def stack(fn):
        return torch.stack([fn(layer).detach() for layer in layers]).contiguous()

    return {
        "conv_w": stack(lambda m: m.conv_layer.conv.weight.permute(2, 1, 0)),
        "conv_b": stack(lambda m: m.conv_layer.conv.bias),
        "cond_w": stack(lambda m: m.conditioner_projection.conv.weight[:, :, 0].t()),
        "cond_b": stack(lambda m: m.conditioner_projection.conv.bias),
        "step_w": stack(lambda m: m.diffusion_projection.linear.weight.t()),
        "out_w": stack(lambda m: m.output_projection.conv.weight[:, :, 0].t()),
        "out_b": stack(lambda m: m.output_projection.conv.bias),
    }


def _projections(cond, step_emb, stacked):
    """Step projections [L, B, C] and conditioner projections [L, B, T, C]
    of every layer (the products the TPU kernel's caller hoists too)."""
    step_proj = torch.einsum("bc,lcd->lbd", step_emb, stacked["step_w"])
    condp = torch.einsum("bth,lhc->lbtc", cond, stacked["cond_w"])
    condp = condp + stacked["cond_b"][:, None, None, :]
    return step_proj.contiguous(), condp.contiguous()


def fused_residual_stack_plain(x, cond, step_emb, stacked):
    """The stack in plain PyTorch (F.conv1d and matmul), any device.
    x [B, T, C], cond [B, T, Hc], step_emb [B, C] -> (x_final, skip_sum)."""
    step_proj, condp = _projections(cond, step_emb, stacked)
    C = x.shape[-1]
    skip = torch.zeros_like(x)
    for l in range(stacked["conv_w"].shape[0]):
        y0 = x + step_proj[l][:, None, :]
        y = y0 + condp[l]
        z = F.conv1d(y.transpose(1, 2), stacked["conv_w"][l].permute(2, 1, 0),
                     stacked["conv_b"][l], padding=1).transpose(1, 2)
        g = torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:])
        o = g @ stacked["out_w"][l] + stacked["out_b"][l]
        x = (o[..., :C] + y0) * (1.0 / math.sqrt(2.0))
        skip = skip + o[..., C:]
    return x, skip


def _entry():
    lib = cuda_build.library("denoiser_stack")
    fn = lib.denoiser_stack_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, fn


def _check(x, cond, step_emb, stacked):
    B, T, C = x.shape
    L = stacked["conv_w"].shape[0]
    want = {"conv_w": (L, 3, C, 2 * C), "conv_b": (L, 2 * C),
            "out_w": (L, C, 2 * C), "out_b": (L, 2 * C)}
    if C not in (128, 256):
        raise ValueError(f"denoiser_stack kernel: C={C}; built for 128 and 256")
    tensors = {"x": x, "cond": cond, "step_emb": step_emb,
               **{k: stacked[k] for k in want}}
    for name, t in tensors.items():
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"denoiser_stack kernel: {name} must be contiguous "
                             f"float32 on {x.device}, got {t.dtype} on {t.device}")
    for name, shape in want.items():
        if tuple(stacked[name].shape) != shape:
            raise ValueError(f"denoiser_stack kernel: {name} has shape "
                             f"{tuple(stacked[name].shape)}, want {shape}")
    if cond.shape[:2] != (B, T) or tuple(step_emb.shape) != (B, C):
        raise ValueError("denoiser_stack kernel: cond must be [B, T, Hc] and "
                         "step_emb [B, C] for x [B, T, C]")


def fused_residual_stack(x, cond, step_emb, stacked):
    """x [B, T, C], cond [B, T, Hc], step_emb [B, C], stacked from
    `stack_denoiser_params` -> (x_final [B, T, C], skip_sum [B, T, C]).

    CUDA tensors run the hand-written kernel (fp32, C in {128, 256}) and
    add the number of kernel launches (one per layer) to
    `fused_residual_stack.launches`; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return fused_residual_stack_plain(x, cond, step_emb, stacked)
    if x.device.type != "cuda":
        raise ValueError(f"denoiser_stack: no kernel for device {x.device}")
    _check(x, cond, step_emb, stacked)
    B, T, C = x.shape
    L = stacked["conv_w"].shape[0]
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        step_proj, condp = _projections(cond, step_emb, stacked)
        x_out = torch.empty_like(x)
        skip = torch.empty_like(x)
        scratch = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), condp.data_ptr(), step_proj.data_ptr(),
                 stacked["conv_w"].data_ptr(), stacked["conv_b"].data_ptr(),
                 stacked["out_w"].data_ptr(), stacked["out_b"].data_ptr(),
                 x_out.data_ptr(), skip.data_ptr(), scratch.data_ptr(),
                 B, T, C, L, stream)
        cuda_build.check(lib, "denoiser_stack", err)
    fused_residual_stack.launches += L
    return x_out, skip


fused_residual_stack.launches = 0
