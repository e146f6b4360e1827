"""The denoiser's gated residual stack: CUDA kernel and plain version.

Counterpart of `mixgantts_tpu/ops/pallas.py` (`fused_residual_stack`,
`stack_denoiser_params`).  Per block (`models/denoiser.ResidualBlock`):

    y0 = x + step_proj;  y = y0 + cond @ Wc + bc      (zero outside [0, T))
    z  = conv_k3(y) -> g = sigmoid(z[:, :C]) * tanh(z[:, C:])
    o  = g @ Wo + bo;  x' = (o[:, :C] + y0) / sqrt(2);  skip += o[:, C:]

The step and conditioner projections of every layer are computed up front
with fp32 matrix products; the L layers then run in
`csrc/denoiser_stack.cu` for CUDA tensors (one launch for all the layers
where the card holds the whole grid at once, one per layer otherwise), or
in `fused_residual_stack_plain` for CPU tensors.

Arithmetic follows the type of conv_w/out_w, as the TPU kernel's operand
type does (`op_dtype = conv_w_ref.dtype`): fp32 weights compute in fp32;
bf16 weights round y and g to bf16, sum the products in fp32 and keep the
biases, y0, the residual and skip in fp32.  On the TPU the JAX package
casts the weights to bf16, and so does `fused_residual_stack` on CUDA:
`csrc/denoiser_stack.cu` is a bf16 tensor-core kernel, fed by
`denoiser_kernel_weights`.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from . import cuda_build
from .mrf import no_tf32

GROUP = 32   # gate channels per CTA of the CUDA kernel (`kGroup` in the source)


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


def _step_projections(step_emb, stacked):
    """Step projections [L, B, C] of every layer."""
    return torch.einsum("bc,lcd->lbd", step_emb, stacked["step_w"]).contiguous()


def _projections(cond, step_emb, stacked):
    """Step projections [L, B, C] and conditioner projections [L, B, T, C]
    of every layer (the products the TPU kernel's caller hoists too)."""
    condp = torch.einsum("bth,lhc->lbtc", cond, stacked["cond_w"])
    condp = condp + stacked["cond_b"][:, None, None, :]
    return _step_projections(step_emb, stacked), condp.contiguous()


def fused_residual_stack_plain(x, cond, step_emb, stacked):
    """The stack in plain PyTorch (F.conv1d and matmul), any device.
    x [B, T, C], cond [B, T, Hc], step_emb [B, C] -> (x_final, skip_sum),
    in the arithmetic of conv_w's type (bf16: `_plain_bf16`)."""
    if stacked["conv_w"].dtype == torch.bfloat16:
        return _plain_bf16(x, cond, step_emb, stacked)
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


def _plain_bf16(x, cond, step_emb, stacked):
    """The TPU kernel's arithmetic with bf16 operands (`pallas.py::_kernel`):
    y = (y0 + condp) and g = sigmoid * tanh rounded to bf16, products of
    bf16-exact values summed in fp32 (TF32 off), the biases added after each
    product, and y0, the residual and skip kept in fp32.  The projections
    stay fp32."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    step_proj, condp = _projections(cond, step_emb, stacked)
    C = x.shape[-1]
    skip = torch.zeros_like(x)
    with no_tf32():
        for l in range(stacked["conv_w"].shape[0]):
            y0 = x + step_proj[l][:, None, :]
            y = bf16(y0 + condp[l])
            z = F.conv1d(y.transpose(1, 2), stacked["conv_w"][l].float().permute(2, 1, 0),
                         padding=1).transpose(1, 2)
            z = z + stacked["conv_b"][l].float()
            g = bf16(torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:]))
            o = g @ stacked["out_w"][l].float() + stacked["out_b"][l].float()
            x = (o[..., :C] + y0) * (1.0 / math.sqrt(2.0))
            skip = skip + o[..., C:]
    return x, skip


def _pack(w):
    """[L, K, 2C] -> bf16 [L, C / GROUP, K * 2 GROUP], in the order the CUDA
    kernel's CTA `rank` reads its B operand: columns [rank GROUP, +GROUP)
    of the first half (gate, or x') then the same of the second half
    (filter, or skip), as n = half * GROUP + j; per 16-deep K slab s, per
    group g of 8 columns, per half h of the slab, an 8 x 8 core matrix
    [n % 8][K % 8]."""
    L, K, N2 = w.shape
    ranks = N2 // 2 // GROUP
    t = w.to(torch.bfloat16).reshape(L, K, 2, ranks, GROUP).permute(0, 3, 1, 2, 4)
    t = t.reshape(L, ranks, K // 16, 2, 8, 2 * GROUP // 8, 8)   # [L, r, s, h, e, g, n%8]
    return t.permute(0, 1, 2, 5, 3, 6, 4).reshape(L, ranks, K * 2 * GROUP).contiguous()


def denoiser_kernel_weights(stacked):
    """Stacked weights as the CUDA kernel takes them: conv_w/out_w in bf16
    (the TPU kernel's operand type, `pallas.py:133-138`), conv_b/out_b in
    fp32, the conditioner projection's weights side by side, `cond_w_cat`
    [Hc, L * C] and `cond_b_cat` [L * C] (one product gives condp in the
    [B, T, L, C] layout the kernel reads), and, where C is a multiple of
    GROUP, the bf16 copies `conv_w_mma` [L, C / 32, 3C * 64] (K = tap * C +
    input channel) and `out_w_mma` [L, C / 32, C * 64] in the kernel's
    order (`_pack`).  `models.denoiser.Denoiser.stacked` makes them once;
    `fused_residual_stack` makes them per call for weights that lack them."""
    conv_w = stacked["conv_w"].to(torch.bfloat16).contiguous()
    out_w = stacked["out_w"].to(torch.bfloat16).contiguous()
    L, _, C, _ = conv_w.shape
    Hc = stacked["cond_w"].shape[1]
    out = dict(stacked, conv_w=conv_w, out_w=out_w,
               conv_b=stacked["conv_b"].float().contiguous(),
               out_b=stacked["out_b"].float().contiguous(),
               cond_w_cat=stacked["cond_w"].permute(1, 0, 2).reshape(Hc, L * C).contiguous(),
               cond_b_cat=stacked["cond_b"].reshape(L * C).contiguous())
    if C % GROUP == 0:
        out.update(conv_w_mma=_pack(conv_w.reshape(L, 3 * C, 2 * C)), out_w_mma=_pack(out_w))
    return out


def _library():
    lib = cuda_build.library("denoiser_stack")
    lib.denoiser_stack_bf16.restype = ctypes.c_int
    lib.denoiser_stack_bf16.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 2)
    return lib


def _check(x, cond, step_emb, stacked):
    """Raise unless the CUDA kernel takes x [B, T, C] (fp32) and the stacked
    weights (conv_w/out_w bf16 or fp32, conv_b/out_b fp32) as they are."""
    B, T, C = x.shape
    L = stacked["conv_w"].shape[0]
    want = {"conv_w": (L, 3, C, 2 * C), "conv_b": (L, 2 * C),
            "out_w": (L, C, 2 * C), "out_b": (L, 2 * C)}
    if C not in (128, 256):
        raise ValueError(f"denoiser_stack kernel: C={C}; built for 128 and 256")
    tensors = {"x": x, "cond": cond, "step_emb": step_emb,
               **{k: stacked[k] for k in want}}
    for name, t in tensors.items():
        dtypes = ((torch.bfloat16, torch.float32) if name in ("conv_w", "out_w")
                  else (torch.float32,))
        if t.device != x.device or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"denoiser_stack kernel: {name} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    for name, shape in want.items():
        if tuple(stacked[name].shape) != shape:
            raise ValueError(f"denoiser_stack kernel: {name} has shape "
                             f"{tuple(stacked[name].shape)}, want {shape}")
    if cond.shape[:2] != (B, T) or tuple(step_emb.shape) != (B, C):
        raise ValueError("denoiser_stack kernel: cond must be [B, T, Hc] and "
                         "step_emb [B, C] for x [B, T, C]")


def _launch(x, cond, step_emb, stacked):
    """Run csrc/denoiser_stack.cu on CUDA tensors with bf16 operands; fp32
    weights are cast (`denoiser_kernel_weights`) for this call.  Returns
    (x_final, skip_sum, launches)."""
    _check(x, cond, step_emb, stacked)
    B, T, C = x.shape
    L = stacked["conv_w"].shape[0]
    if "conv_w_mma" not in stacked:
        stacked = denoiser_kernel_weights(stacked)
    Hc = cond.shape[-1]
    packed = {"conv_w_mma": (torch.bfloat16, (L, C // GROUP, 3 * C * 2 * GROUP)),
              "out_w_mma": (torch.bfloat16, (L, C // GROUP, C * 2 * GROUP)),
              "cond_w_cat": (torch.float32, (Hc, L * C)), "cond_b_cat": (torch.float32, (L * C,))}
    for key, (dtype, shape) in packed.items():
        t = stacked.get(key)
        if (t is None or tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"denoiser_stack kernel: {key} must be contiguous {dtype} "
                             f"{shape} on {x.device}; make it with denoiser_kernel_weights")
    lib = _library()
    with torch.cuda.device(x.device):
        # the products `_projections` computes, condp as [B * T, L * C] by
        # one matrix product with its bias (no layout copy)
        step_proj = _step_projections(step_emb, stacked)
        condp = torch.addmm(stacked["cond_b_cat"], cond.reshape(B * T, Hc),
                            stacked["cond_w_cat"])
        x_out = torch.empty_like(x)
        skip = torch.empty_like(x)
        scratch = torch.empty_like(x)
        halo = torch.empty(B * -(-T // 64) * 4 * C, dtype=torch.int64, device=x.device)
        launches = ctypes.c_int(0)
        err = lib.denoiser_stack_bf16(
            x.data_ptr(), condp.data_ptr(), step_proj.data_ptr(),
            stacked["conv_w_mma"].data_ptr(), stacked["conv_b"].data_ptr(),
            stacked["out_w_mma"].data_ptr(), stacked["out_b"].data_ptr(),
            x_out.data_ptr(), skip.data_ptr(), scratch.data_ptr(), halo.data_ptr(),
            B, T, C, L, torch.cuda.current_stream().cuda_stream, ctypes.addressof(launches))
        cuda_build.check(lib, "denoiser_stack", err)
    return x_out, skip, launches.value


def launch_shape(B, T, C):
    """(CTAs of the whole grid, CTAs per cluster, clusters the device holds
    at once) of the CUDA kernel at B, T and width C."""
    lib = _library()
    lib.denoiser_stack_cluster_size.restype = ctypes.c_int
    lib.denoiser_stack_cluster_size.argtypes = [ctypes.c_int]
    lib.denoiser_stack_max_active_clusters.restype = ctypes.c_int
    lib.denoiser_stack_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cluster = lib.denoiser_stack_cluster_size(C)
    n = ctypes.c_int(0)
    cuda_build.check(lib, "denoiser_stack",
                     lib.denoiser_stack_max_active_clusters(C, ctypes.addressof(n)))
    return B * -(-T // 64) * cluster, cluster, n.value


def fused_residual_stack(x, cond, step_emb, stacked):
    """x [B, T, C], cond [B, T, Hc], step_emb [B, C], stacked from
    `stack_denoiser_params` (or `denoiser_kernel_weights`) ->
    (x_final [B, T, C], skip_sum [B, T, C]).

    CUDA tensors run the hand-written bf16 tensor-core kernel (C in {128,
    256}; fp32 weights are cast per call) and add the number of kernel
    launches (one for all the layers, a few for a batch larger than the
    card holds at once, one per layer for a sequence too long for that) to
    `fused_residual_stack.launches`; CPU tensors run the plain version in
    the weights' type."""
    if x.device.type == "cpu":
        return fused_residual_stack_plain(x, cond, step_emb, stacked)
    if x.device.type != "cuda":
        raise ValueError(f"denoiser_stack: no kernel for device {x.device}")
    x_out, skip, launches = _launch(x, cond, step_emb, stacked)
    fused_residual_stack.launches += launches
    return x_out, skip


fused_residual_stack.launches = 0
