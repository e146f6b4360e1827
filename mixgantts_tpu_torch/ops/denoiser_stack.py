"""The denoiser's gated residual stack: CUDA kernel and plain version.

Counterpart of `mixgantts_tpu/ops/pallas.py` (`fused_residual_stack`,
`stack_denoiser_params`).  Per block (`models/denoiser.ResidualBlock`):

    y0 = x + step_proj;  y = y0 + cond @ Wc + bc [+ spk_proj]   (zero outside [0, T))
    z  = conv_k3(y) -> g = sigmoid(z[:, :C]) * tanh(z[:, C:])
    o  = g @ Wo + bo;  x' = (o[:, :C] + y0) / sqrt(2);  skip += o[:, C:]

The step and conditioner projections of every layer are computed up front
with fp32 matrix products; a multi-speaker denoiser's per-layer speaker term
`spk_proj` [L, B, C] joins the conditioner projection (it reaches y, never
the residual y0, as in `mixgantts_tpu/models/denoiser.py::ResidualBlock`).
The L layers then run in
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

Activations (x, cond, step_emb) may be fp32 or bf16, as the TPU kernel
reads them: bf16 ones are upcast exactly, the hoisted projections are
rounded to bf16 (as the JAX package's bf16 products are), the layers keep
fp32 state, and the outputs come back in x's type.

Widths: the TPU kernel takes any C (its blocks span the whole channel
axis).  The CUDA kernel is built for C in KERNEL_WIDTHS (a cluster of C / 32
CTAs, each owning 32 channels, with whole 8 KB weight chunks; 512 takes
clusters of 16, beyond the portable 8), so a stack of any C <= 512 runs
there at the next of them, Cp, with zero channels above C
(`pad_denoiser_width`, `pad_channels`), and its outputs are cut back to C.
The zero channels are exact: a zero gate channel gives sigmoid(0) * tanh(0)
= 0, and zero weight rows add nothing to the fp32 sums.  The weights are
padded once, in `denoiser_kernel_weights`; x, the step projections and the
conditioner projections come at Cp per call.  Wider than 512 would take
clusters of more than 16 CTAs, which an H100 does not run: such a stack
runs the wide route of the same source (`wide_conv_gate` and
`wide_out_proj`, two launches a layer, g through device memory) at the next
multiple of WIDE_UNIT, with the same zero channels and the same weight
layout.  Only device memory limits C.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_build
from .mrf import no_tf32, pad_channels, upcast

GROUP = 32   # gate channels per CTA of the CUDA kernel (`kGroup` in the source)
KERNEL_WIDTHS = (64, 128, 256, 512)   # the C the CUDA kernel is built for (`Layout<C>`)
WIDE_UNIT = 64   # above 512 the wide route runs C padded to a multiple of this (`kWideK`)


def stack_denoiser_params(denoiser):
    """A port `models.denoiser.Denoiser` -> stacked per-layer tensors in the
    JAX package's layout: conv_w [L, 3, C, 2C], conv_b [L, 2C],
    cond_w [L, Hc, C], cond_b [L, C], step_w [L, C, C], out_w [L, C, 2C],
    out_b [L, 2C], and a multi-speaker denoiser's spk_w [L, H, C]."""
    layers = list(denoiser.residual_layers)

    def stack(fn):
        return torch.stack([fn(layer).detach() for layer in layers]).contiguous()

    out = {
        "conv_w": stack(lambda m: m.conv_layer.conv.weight.permute(2, 1, 0)),
        "conv_b": stack(lambda m: m.conv_layer.conv.bias),
        "cond_w": stack(lambda m: m.conditioner_projection.conv.weight[:, :, 0].t()),
        "cond_b": stack(lambda m: m.conditioner_projection.conv.bias),
        "step_w": stack(lambda m: m.diffusion_projection.linear.weight.t()),
        "out_w": stack(lambda m: m.output_projection.conv.weight[:, :, 0].t()),
        "out_b": stack(lambda m: m.output_projection.conv.bias),
    }
    if getattr(layers[0], "speaker_projection", None) is not None:
        out["spk_w"] = stack(lambda m: m.speaker_projection.linear.weight.t())
    return out


def speaker_projections(spk_emb, stacked):
    """The per-layer speaker terms [L, B, C] of speaker embeddings [B, H]
    (fp32 products of the stacked `spk_w`)."""
    return torch.einsum("bh,lhc->lbc", upcast(spk_emb), stacked["spk_w"].float()).contiguous()


def _round(t, dtype):
    """t rounded to the activations' type and back: bf16 activations round
    a hoisted product as the JAX package's bf16 einsum does."""
    return t.to(dtype).float() if dtype == torch.bfloat16 else t


def _step_projections(step_emb, stacked, dtype=torch.float32):
    """Step projections [L, B, C] of every layer."""
    return _round(torch.einsum("bc,lcd->lbd", step_emb, stacked["step_w"].float()),
                  dtype).contiguous()


def hoisted_projections(cond, step_emb, stacked, spk_proj=None, dtype=torch.float32):
    """Step projections [L, B, C] and conditioner projections [L, B, T, C]
    of every layer (the products the TPU kernel's caller hoists too), the
    speaker term added to the latter, both rounded to `dtype`.  (Each has
    the width of its own weights: `pad_denoiser_width` leaves step_w at C.)"""
    condp = torch.einsum("bth,lhc->lbtc", cond, stacked["cond_w"].float())
    condp = condp + stacked["cond_b"].float()[:, None, None, :]
    if spk_proj is not None:
        condp = condp + spk_proj[:, :, None, :]
    return _step_projections(step_emb, stacked, dtype), _round(condp, dtype).contiguous()


def fused_residual_stack_plain(x, cond, step_emb, stacked, spk_proj=None):
    """The stack in plain PyTorch (F.conv1d and matmul), any device.
    x [B, T, C], cond [B, T, Hc], step_emb [B, C], spk_proj [L, B, C] or
    None -> (x_final, skip_sum) in x's type, in the arithmetic of conv_w's
    type (bf16: `_layers_bf16`)."""
    dtype = x.dtype
    x, cond, step_emb = upcast(x), upcast(cond), upcast(step_emb)
    step_proj, condp = hoisted_projections(cond, step_emb, stacked, spk_proj, dtype)
    x, skip = residual_layers_plain(x, step_proj, condp, stacked)
    return x.to(dtype), skip.to(dtype)


def residual_layers_plain(x, step_proj, condp, stacked):
    """The L layers on the hoisted projections, what the CUDA kernel
    runs: fp32 x [B, T, C], step_proj [L, B, C] and condp [L, B, T, C] ->
    (x_final, skip_sum), in the arithmetic of conv_w's type."""
    layers = _layers_bf16 if stacked["conv_w"].dtype == torch.bfloat16 else _layers
    return layers(x, step_proj, condp, stacked)


def _layers(x, step_proj, condp, stacked):
    """The L layers in the weights' own type."""
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


def _layers_bf16(x, step_proj, condp, stacked):
    """The L layers in the TPU kernel's arithmetic with bf16 operands
    (`pallas.py::_kernel`): y = (y0 + condp) and g = sigmoid * tanh rounded
    to bf16, products of bf16-exact values summed in fp32 (TF32 off), the
    biases added after each product, and y0, the residual and skip kept in
    fp32."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

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


def kernel_width(C):
    """The width Cp at which the CUDA kernel runs a C-channel stack: the
    least of KERNEL_WIDTHS that is >= C, or above the widest (the wide
    route) C rounded up to a multiple of WIDE_UNIT."""
    for Cp in KERNEL_WIDTHS:
        if C <= Cp:
            return Cp
    return -(-C // WIDE_UNIT) * WIDE_UNIT


def is_wide(C):
    """Whether a C-channel stack runs the wide route (two launches a layer)."""
    return C > KERNEL_WIDTHS[-1]


def _pad_halves(w, C, Cp):
    """[..., 2C] holding two halves of C -> [..., 2Cp], each half padded
    on its own ([:C] -> [:Cp], [C:] -> [Cp:Cp + C])."""
    return torch.cat([pad_channels(w[..., :C], Cp), pad_channels(w[..., C:], Cp)], dim=-1)


def pad_denoiser_width(stacked, Cp):
    """Stacked weights of width C (`stack_denoiser_params`' layout) -> the
    weights the CUDA kernel reads at width Cp >= C, with zero channels:
    conv_w [L, 3, Cp, 2Cp], conv_b [L, 2Cp], out_w [L, Cp, 2Cp] and out_b
    [L, 2Cp] with each half (gate | filter, residual | skip) padded on its
    own, cond_w [L, Hc, Cp] and cond_b [L, Cp].  step_w and spk_w stay at
    C: `_launch` projects at C and pads the projections (`pad_channels`).
    The layers at Cp (`residual_layers_plain`) of x, the step projections
    and the speaker term padded so, equal on their first C channels the
    layers at C: the zero channels stay zero."""
    C = stacked["conv_w"].shape[-2]

    def rows(w):   # the input channels, the axis before the last
        return F.pad(w, (0, 0, 0, Cp - C))

    return dict(stacked,
                conv_w=_pad_halves(rows(stacked["conv_w"]), C, Cp),
                conv_b=_pad_halves(stacked["conv_b"], C, Cp),
                out_w=_pad_halves(rows(stacked["out_w"]), C, Cp),
                out_b=_pad_halves(stacked["out_b"], C, Cp),
                cond_w=pad_channels(stacked["cond_w"], Cp),
                cond_b=pad_channels(stacked["cond_b"], Cp))


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
    """Stacked weights as the CUDA kernel takes them.  The stack itself,
    for the plain version: conv_w/out_w in bf16 (the TPU kernel's operand
    type, `pallas.py:133-138`), conv_b/out_b, cond_w/cond_b, step_w (and a
    multi-speaker stack's spk_w) in fp32.  And the kernel's own tensors at
    its width Cp (`kernel_width`, the same layout on both routes; zero channels
    above C, `pad_denoiser_width`): the bf16 copies `conv_w_mma` [L, Cp / 32,
    3Cp * 64] (K = tap * Cp + input channel) and `out_w_mma` [L, Cp / 32,
    Cp * 64] in the kernel's order (`_pack`), `conv_b_mma`/`out_b_mma`
    [L, 2Cp] fp32, and the conditioner projection's weights side by side,
    `cond_w_cat` [Hc, L * Cp] and `cond_b_cat` [L * Cp] (one product gives
    condp in the [B, T, L, Cp] layout the kernel reads).
    `models.denoiser.Denoiser.stacked` makes them once;
    `fused_residual_stack` makes them per call for weights that lack them."""
    conv_w = stacked["conv_w"].to(torch.bfloat16).contiguous()
    out_w = stacked["out_w"].to(torch.bfloat16).contiguous()
    L, _, C, _ = conv_w.shape
    out = dict(stacked, conv_w=conv_w, out_w=out_w)
    for key in ("conv_b", "out_b", "cond_w", "cond_b", "step_w", "spk_w"):
        if key in stacked:
            out[key] = stacked[key].float().contiguous()
    Cp = kernel_width(C)
    padded = pad_denoiser_width(out, Cp)
    Hc = padded["cond_w"].shape[1]
    out.update(
        conv_w_mma=_pack(padded["conv_w"].reshape(L, 3 * Cp, 2 * Cp)),
        out_w_mma=_pack(padded["out_w"]),
        conv_b_mma=padded["conv_b"].contiguous(), out_b_mma=padded["out_b"].contiguous(),
        cond_w_cat=padded["cond_w"].permute(1, 0, 2).reshape(Hc, L * Cp).contiguous(),
        cond_b_cat=padded["cond_b"].reshape(L * Cp).contiguous())
    return out


def _library():
    lib = cuda_build.library("denoiser_stack")
    lib.denoiser_stack_bf16.restype = ctypes.c_int
    lib.denoiser_stack_bf16.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 2)
    lib.denoiser_stack_wide_bf16.restype = ctypes.c_int
    lib.denoiser_stack_wide_bf16.argtypes = lib.denoiser_stack_bf16.argtypes
    return lib


def _check(x, cond, step_emb, stacked, spk_proj=None):
    """Raise unless the CUDA kernel takes x [B, T, C] (fp32), the stacked
    weights (conv_w/out_w bf16 or fp32, conv_b/out_b fp32) and the speaker
    term spk_proj [L, B, C] (fp32, or None) as they are."""
    B, T, C = x.shape
    L = stacked["conv_w"].shape[0]
    want = {"conv_w": (L, 3, C, 2 * C), "conv_b": (L, 2 * C),
            "out_w": (L, C, 2 * C), "out_b": (L, 2 * C)}
    tensors = {"x": x, "cond": cond, "step_emb": step_emb,
               **{k: stacked[k] for k in want}}
    if spk_proj is not None:
        tensors["spk_proj"] = spk_proj
    for name, t in tensors.items():
        dtypes = ((torch.bfloat16, torch.float32) if name in ("conv_w", "out_w")
                  else (torch.float32,))
        if t.device != x.device or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"denoiser_stack kernel: {name} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    if spk_proj is not None:
        want["spk_proj"] = (L, B, C)
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"denoiser_stack kernel: {name} has shape "
                             f"{tuple(tensors[name].shape)}, want {shape}")
    if cond.shape[:2] != (B, T) or tuple(step_emb.shape) != (B, C):
        raise ValueError("denoiser_stack kernel: cond must be [B, T, Hc] and "
                         "step_emb [B, C] for x [B, T, C]")


def _launch(x, cond, step_emb, stacked, spk_proj=None, dtype=torch.float32):
    """Run csrc/denoiser_stack.cu on CUDA tensors with bf16 operands, at
    the kernel's width Cp (`kernel_width`: x, the step and conditioner
    projections with zero channels above C, the outputs cut back to C;
    above 512 the wide route, `is_wide`);
    fp32 weights are cast (`denoiser_kernel_weights`) for this call, and the
    hoisted projections are rounded to `dtype`, the activations' type.
    Returns (x_final, skip_sum, launches)."""
    _check(x, cond, step_emb, stacked, spk_proj)
    B, T, C = x.shape
    Cp = kernel_width(C)
    L = stacked["conv_w"].shape[0]
    if "conv_w_mma" not in stacked:
        stacked = denoiser_kernel_weights(stacked)
    Hc = cond.shape[-1]
    packed = {"conv_w_mma": (torch.bfloat16, (L, Cp // GROUP, 3 * Cp * 2 * GROUP)),
              "out_w_mma": (torch.bfloat16, (L, Cp // GROUP, Cp * 2 * GROUP)),
              "conv_b_mma": (torch.float32, (L, 2 * Cp)), "out_b_mma": (torch.float32, (L, 2 * Cp)),
              "cond_w_cat": (torch.float32, (Hc, L * Cp)), "cond_b_cat": (torch.float32, (L * Cp,))}
    for key, (want, shape) in packed.items():
        t = stacked.get(key)
        if (t is None or tuple(t.shape) != shape or t.dtype != want or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"denoiser_stack kernel: {key} must be contiguous {want} "
                             f"{shape} on {x.device}; make it with denoiser_kernel_weights")
    lib = _library()
    with torch.cuda.device(x.device):
        # the products `hoisted_projections` computes, at Cp; condp as [B * T,
        # L * Cp] by one matrix product with its bias (no layout copy); the
        # speaker term joins the bias, one row of it per batch row
        step_proj = pad_channels(_step_projections(step_emb, stacked, dtype), Cp).contiguous()
        if spk_proj is None:
            condp = torch.addmm(stacked["cond_b_cat"], cond.reshape(B * T, Hc),
                                stacked["cond_w_cat"])
        else:
            bias = stacked["cond_b_cat"] + pad_channels(spk_proj, Cp).transpose(0, 1).reshape(
                B, 1, L * Cp)
            condp = torch.baddbmm(bias, cond, stacked["cond_w_cat"].expand(B, Hc, L * Cp))
        condp = _round(condp, dtype)
        xp = pad_channels(x, Cp).contiguous()
        x_out = torch.empty_like(xp)
        skip = torch.empty_like(xp)
        scratch = torch.empty_like(xp)
        tiles = -(-T // 64)
        if is_wide(Cp):   # g of a layer, [B, tiles, Cp / 8, 64, 8] bf16
            run = lib.denoiser_stack_wide_bf16
            buf = torch.empty(B * tiles * 64 * Cp, dtype=torch.bfloat16, device=x.device)
        else:             # the tiles' tagged edge rows, [B, tiles, 4, Cp]
            run = lib.denoiser_stack_bf16
            buf = torch.empty(B * tiles * 4 * Cp, dtype=torch.int64, device=x.device)
        launches = ctypes.c_int(0)
        err = run(
            xp.data_ptr(), condp.data_ptr(), step_proj.data_ptr(),
            stacked["conv_w_mma"].data_ptr(), stacked["conv_b_mma"].data_ptr(),
            stacked["out_w_mma"].data_ptr(), stacked["out_b_mma"].data_ptr(),
            x_out.data_ptr(), skip.data_ptr(), scratch.data_ptr(), buf.data_ptr(),
            B, T, Cp, L, torch.cuda.current_stream().cuda_stream, ctypes.addressof(launches))
        cuda_build.check(lib, "denoiser_stack", err)
    return x_out[..., :C].contiguous(), skip[..., :C].contiguous(), launches.value


def launch_shape(B, T, C):
    """(CTAs of the whole grid, CTAs per cluster, clusters the device holds
    at once) of the CUDA kernel at B, T and width C (run at `kernel_width`;
    above 512 the wide route's conv launch, clusters of one CTA)."""
    C = kernel_width(C)
    lib = _library()
    lib.denoiser_stack_cluster_size.restype = ctypes.c_int
    lib.denoiser_stack_cluster_size.argtypes = [ctypes.c_int]
    lib.denoiser_stack_max_active_clusters.restype = ctypes.c_int
    lib.denoiser_stack_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cluster = lib.denoiser_stack_cluster_size(C)
    n = ctypes.c_int(0)
    cuda_build.check(lib, "denoiser_stack",
                     lib.denoiser_stack_max_active_clusters(C, ctypes.addressof(n)))
    return B * -(-T // 64) * (C // GROUP), cluster, n.value


def fused_residual_stack(x, cond, step_emb, stacked, spk_proj=None):
    """x [B, T, C], cond [B, T, Hc], step_emb [B, C], stacked from
    `stack_denoiser_params` (or `denoiser_kernel_weights`), and a
    multi-speaker denoiser's per-layer speaker term spk_proj [L, B, C]
    (`speaker_projections`, else None) -> (x_final [B, T, C], skip_sum
    [B, T, C]) in x's type.  Activations are fp32, or bf16 (upcast exactly,
    the projections rounded to bf16).

    CUDA tensors run the hand-written bf16 tensor-core kernel (any C, at
    `kernel_width`; fp32 weights are cast per call) and add the number of kernel
    launches (one for all the layers, a few for a batch larger than the
    card holds at once, one per layer for a sequence too long for that, two
    per layer above 512) to `fused_residual_stack.launches`; CPU tensors run
    the plain version in the weights' type."""
    with span("kernel.fused_residual_stack"):
        if x.device.type == "cpu":
            return fused_residual_stack_plain(x, cond, step_emb, stacked, spk_proj)
        if x.device.type != "cuda":
            raise ValueError(f"denoiser_stack: no kernel for device {x.device}")
        x_out, skip, launches = _launch(upcast(x), upcast(cond), upcast(step_emb), stacked,
                                        spk_proj, x.dtype)
        fused_residual_stack.launches += launches
        return x_out.to(x.dtype), skip.to(x.dtype)


fused_residual_stack.launches = 0
