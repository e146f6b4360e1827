"""HiFi-GAN's multi-receptive-field (MRF) stage: CUDA kernels and plain
version.

Counterpart of `mixgantts_tpu/ops/pallas_vocoder.py` (`mrf_stack`,
`mrf_stack_folded`, `mrf_stack_streamed`, `stack_mrf_params`,
`stack_mrf_params_folded`).  For each branch (kernel k), a chain of
residual pairs leaky_relu -> dilated conv -> leaky_relu -> conv, added to
the branch input; the stage returns the mean of the branch outputs.  Convolutions use zero
("SAME") padding.

Stacked weights keep the JAX package's layout: w1/w2 [n_br, n_pair, 11, C,
C] (taps centred in 11, then input channel, output channel), b1/b2
[n_br, n_pair, C].  The time-folded layout of the TPU kernel holds the same
bytes as a contiguous [B, T, C] tensor, so `mrf_stack_folded` views it as
such and runs the same CUDA kernel (`csrc/mrf_stack.cu`, one launch per
branch and pair).  `mrf_stack_streamed` runs a whole C = 256 stage in one
launch (`csrc/mrf_stack_streamed.cu`, a tile of frames per cluster of 4
CTAs that split the output channels).

Arithmetic follows the weights' type, as the TPU kernels' operand type
does (`op_dtype = w1_ref.dtype`): fp32 weights compute in fp32; bf16
weights round the stage input and every conv input to bf16, accumulate in
fp32 and keep biases, residual and branch mean in fp32.  On the TPU the
JAX package always casts the weights to bf16, and so do the three entry
points on CUDA: `csrc/mrf_stack.cu` and `csrc/mrf_stack_streamed.cu` are
bf16 tensor-core kernels, fed by `kernel_weights`.

The signal x may be fp32 or bf16 (a vocoder computing in bf16, as the TPU
kernels read it under the JAX package's bf16 compute): bf16 is upcast
exactly into the fp32-input kernels and plain version, and the output comes
back in x's type.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

LRELU_SLOPE = 0.1
TAPS = 11  # every kernel is zero-padded to the largest (k = 11)


def stack_mrf_params(generator, stage, kernel_sizes=(3, 7, 11),
                     dilations=(1, 3, 5), branches=None):
    """A port `models.hifigan.HiFiGANGenerator` -> the stacked weights of
    one stage.  `branches` restricts to (branch index, kernel size) pairs,
    as the JAX function does for the one-branch-per-call C = 256 stage."""
    if branches is None:
        branches = list(enumerate(kernel_sizes))
    n_k = len(generator.resblock_kernel_sizes)
    w1, b1, w2, b2 = [], [], [], []
    for j, rk in branches:
        block = generator.resblocks[stage * n_k + j]
        pad = (TAPS - rk) // 2

        def taps(conv):  # torch [out, in, k] -> [11, in, out]
            return F.pad(conv.weight.detach().permute(2, 1, 0),
                         (0, 0, 0, 0, pad, pad))

        w1.append(torch.stack([taps(block.convs1[c]) for c in range(len(dilations))]))
        w2.append(torch.stack([taps(block.convs2[c]) for c in range(len(dilations))]))
        b1.append(torch.stack([block.convs1[c].bias.detach()
                               for c in range(len(dilations))]))
        b2.append(torch.stack([block.convs2[c].bias.detach()
                               for c in range(len(dilations))]))
    return {"w1": torch.stack(w1).contiguous(), "b1": torch.stack(b1).contiguous(),
            "w2": torch.stack(w2).contiguous(), "b2": torch.stack(b2).contiguous()}


def stack_mrf_params_folded(generator, stage, fold, kernel_sizes=(3, 7, 11),
                            dilations=(1, 3, 5)):
    """`stack_mrf_params` plus the fold F: the kernel keeps the unfolded
    taps, since the folded signal is only a view of [B, T, C]."""
    return dict(stack_mrf_params(generator, stage, kernel_sizes, dilations),
                fold=fold)


def upcast(t):
    """bf16 activations upcast to fp32 (exact); anything else as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def mrf_stack_plain(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """The MRF stage in plain PyTorch (F.conv1d), any device.
    x [B, T, C] -> [B, T, C] in x's type, in the arithmetic of the weights'
    type (bf16 weights: `_mrf_stack_plain_bf16`)."""
    dtype = x.dtype
    x = upcast(x)
    if stacked["w1"].dtype == torch.bfloat16:
        return _mrf_stack_plain_bf16(x, stacked, kernel_sizes, dilations).to(dtype)
    xt = x.transpose(1, 2)
    acc = None
    for br, rk in enumerate(kernel_sizes):
        pad = (TAPS - rk) // 2
        y = xt
        for p, d in enumerate(dilations):
            w1 = stacked["w1"][br, p, pad:TAPS - pad].permute(2, 1, 0)
            w2 = stacked["w2"][br, p, pad:TAPS - pad].permute(2, 1, 0)
            t = F.leaky_relu(y, LRELU_SLOPE)
            t = F.conv1d(t, w1, stacked["b1"][br, p], dilation=d,
                         padding=d * (rk - 1) // 2)
            t = F.leaky_relu(t, LRELU_SLOPE)
            t = F.conv1d(t, w2, stacked["b2"][br, p], padding=(rk - 1) // 2)
            y = y + t
        acc = y if acc is None else acc + y
    return (acc / len(kernel_sizes)).transpose(1, 2).to(dtype)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and matmuls in full fp32 (PyTorch lets cuDNN use
    TF32 by default on the card): the denoiser's plain bf16 version sums its
    products of bf16-exact values as fp32."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _mrf_stack_plain_bf16(x, stacked, kernel_sizes, dilations):
    """The TPU kernel's arithmetic with bf16 operands
    (`pallas_vocoder.py::_kernel`): the stage input and each conv input
    lrelu(.) * mask rounded to bf16, the products of bf16-exact values summed
    and rounded to fp32, biases, residual and branch mean added in fp32.  The
    convolutions run in float64, so each sum is the exactly rounded fp32 one
    that any order of fp32 additions only approaches (PyTorch's fp32 CPU
    convolution at C = 256, K = 11 * 256, drifts from it by 6e-5 of max|y|
    on average after a stage, five times the Pallas kernel's drift)."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    def conv(t, w, **kwargs):
        return F.conv1d(t.double(), w.double(), **kwargs).float()

    xt = bf16(x).transpose(1, 2)
    acc = None
    for br, rk in enumerate(kernel_sizes):
        pad = (TAPS - rk) // 2
        y = xt
        for p, d in enumerate(dilations):
            w1 = stacked["w1"][br, p, pad:TAPS - pad].permute(2, 1, 0)
            w2 = stacked["w2"][br, p, pad:TAPS - pad].permute(2, 1, 0)
            t = conv(bf16(F.leaky_relu(y, LRELU_SLOPE)), w1, dilation=d,
                     padding=d * (rk - 1) // 2)
            t = t + stacked["b1"][br, p].float()[:, None]
            t = conv(bf16(F.leaky_relu(t, LRELU_SLOPE)), w2, padding=(rk - 1) // 2)
            y = y + (t + stacked["b2"][br, p].float()[:, None])
        acc = y if acc is None else acc + y
    return (acc / len(kernel_sizes)).transpose(1, 2)


def _pack_taps(w, kernel_sizes):
    """[n_br, n_pair, 11, C, C] -> bf16 [n_br, n_pair, 11 * C * C]: each
    (branch, pair) holds its k real taps first, flattened to K = tap * C +
    input channel and laid out in the order `csrc/mrf_mma.cuh` reads it: per
    16-deep K slab s, per group g of 8 output channels, per half h of the
    slab, an 8 x 8 core matrix [output channel % 8][K % 8]."""
    n_br, n_pair, _, C, _ = w.shape
    out = torch.zeros(n_br, n_pair, TAPS * C * C, dtype=torch.bfloat16, device=w.device)
    for br, rk in enumerate(kernel_sizes):
        pad = (TAPS - rk) // 2
        t = w[br, :, pad:pad + rk].to(torch.bfloat16)          # [p, tap, c_in, c_out]
        t = t.reshape(n_pair, rk * C // 16, 2, 8, C // 8, 8)   # [p, s, h, e, g, r]
        out[br, :, :rk * C * C] = t.permute(0, 1, 4, 2, 5, 3).reshape(n_pair, -1)
    return out


def kernel_weights(stacked, kernel_sizes=(3, 7, 11)):
    """Stacked weights as the CUDA kernels take them: w1/w2
    in bf16 (the TPU kernel's operand type, `pallas_vocoder.py:535-539`),
    b1/b2 in fp32, and the bf16 copies `w1_mma`/`w2_mma` in the kernel's
    order for `kernel_sizes`.  `models.hifigan.fused_apply` makes them once
    per stage; the entry points make them per call for weights that lack
    them."""
    w1 = stacked["w1"].to(torch.bfloat16).contiguous()
    w2 = stacked["w2"].to(torch.bfloat16).contiguous()
    return dict(stacked, w1=w1, w2=w2,
                b1=stacked["b1"].float().contiguous(), b2=stacked["b2"].float().contiguous(),
                w1_mma=_pack_taps(w1, kernel_sizes), w2_mma=_pack_taps(w2, kernel_sizes),
                mma_kernel_sizes=tuple(kernel_sizes))


def _check(name, x, stacked, kernel_sizes, dilations, widths):
    """Raise unless a CUDA kernel takes x [B, T, C] (fp32) and the stacked
    weights (bf16 or fp32; `kernel_weights` casts them) as they are."""
    B, T, C = x.shape
    n_br, n_pair = len(kernel_sizes), len(dilations)
    if C not in widths:
        raise ValueError(f"{name} kernel: C={C}; built for "
                         f"{', '.join(map(str, widths))}")
    if any(k not in (3, 7, 11) for k in kernel_sizes):
        raise ValueError(f"{name} kernel: kernel sizes {kernel_sizes}; "
                         "built for 3, 7 and 11")
    if any(not 1 <= d <= 5 for d in dilations):
        raise ValueError(f"{name} kernel: dilations {dilations}; the "
                         "shared-memory tile holds dilations 1 to 5")
    want = {"w1": (n_br, n_pair, TAPS, C, C), "w2": (n_br, n_pair, TAPS, C, C),
            "b1": (n_br, n_pair, C), "b2": (n_br, n_pair, C)}
    for key in ("x", *want):
        t = x if key == "x" else stacked[key]
        dtypes = (torch.float32,) if key == "x" else (torch.bfloat16, torch.float32)
        if t.device != x.device or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {key} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if key != "x" and tuple(t.shape) != want[key]:
            raise ValueError(f"{name} kernel: {key} has shape "
                             f"{tuple(t.shape)}, want {want[key]}")


def _int_array(values):
    """A host int array as a pointer argument (the pointer keeps it alive)."""
    return ctypes.cast((ctypes.c_int * len(values))(*values), ctypes.c_void_p)


def _mma_weights(name, x, stacked, kernel_sizes, dilations, widths):
    """Check x and the stacked weights for a bf16 CUDA kernel and return
    them with their wgmma-ordered copies (`kernel_weights`, made for this
    call where fp32 weights lack them); raise on what the kernel does not
    take."""
    C = x.shape[-1]
    _check(name, x, stacked, kernel_sizes, dilations, widths)
    if "w1_mma" not in stacked:
        stacked = kernel_weights(stacked, kernel_sizes)
    packed = (len(kernel_sizes), len(dilations), TAPS * C * C)
    if (stacked["mma_kernel_sizes"] != kernel_sizes
            or any(stacked[k].shape != packed or stacked[k].dtype != torch.bfloat16
                   or stacked[k].device != x.device for k in ("w1_mma", "w2_mma"))
            or any(stacked[k].dtype != torch.float32 for k in ("b1", "b2"))):
        raise ValueError(f"{name} kernel: w1_mma/w2_mma must be bf16 {packed} on "
                         f"{x.device}, laid out for kernel sizes {kernel_sizes}, and "
                         "b1/b2 fp32; make them with kernel_weights")
    return stacked


def _launch(x, stacked, kernel_sizes, dilations):
    """Run csrc/mrf_stack.cu on a CUDA x [B, T, C] (fp32) with bf16
    operands; fp32 weights are cast (`kernel_weights`) for this call.
    Returns (out, launches)."""
    B, T, C = x.shape
    n_br, n_pair = len(kernel_sizes), len(dilations)
    stacked = _mma_weights("mrf_stack", x, stacked, kernel_sizes, dilations,
                           (32, 64, 128, 256))
    lib = cuda_build.library("mrf_stack")
    fn = lib.mrf_stack_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    ks, ds = _int_array(kernel_sizes), _int_array(dilations)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
                 stacked["w1_mma"].data_ptr(), stacked["b1"].data_ptr(),
                 stacked["w2_mma"].data_ptr(), stacked["b2"].data_ptr(), B, T, C, n_br, n_pair,
                 ks, ds, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "mrf_stack", err)
    return out, n_br * n_pair


def tile_frames(C, k):
    """Output frames one block of the CUDA kernel owns at width C and
    kernel size k (blocks per launch = B * ceil(T / frames))."""
    lib = cuda_build.library("mrf_stack")
    lib.mrf_stack_tile_frames.restype = ctypes.c_int
    lib.mrf_stack_tile_frames.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib.mrf_stack_tile_frames(C, k)


def mrf_stack(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """x [B, T, C], stacked from `stack_mrf_params` -> the averaged MRF
    output [B, T, C].

    CUDA tensors run the hand-written bf16 tensor-core kernel (one launch
    per branch and pair, counted in `mrf_stack.launches`) on the weights of
    `kernel_weights` (fp32 weights are cast per call); CPU tensors run the
    plain version in the weights' type.  bf16 x is upcast, and the output
    comes back in x's type."""
    if x.device.type == "cpu":
        return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack: no kernel for device {x.device}")
    out, n = _launch(upcast(x), stacked, tuple(kernel_sizes), tuple(dilations))
    mrf_stack.launches += n
    return out.to(x.dtype)


mrf_stack.launches = 0


def mrf_stack_folded(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                     prefolded=False):
    """The MRF stage for the narrow stages (C = 64 and 32 in HiFi-GAN V1).

    prefolded=True takes x in the TPU kernel's folded layout [B, T/F, F*C]
    (x_folded[b, i, f*C + c] == x[b, F*i + f, c]), which is a view of the
    contiguous [B, T, C] signal; otherwise x is [B, T, C].  Returns
    [B, T, C] in x's type.  CUDA tensors run the same bf16 kernel as
    `mrf_stack`, counted in `mrf_stack_folded.launches`; CPU tensors run the
    plain version."""
    if prefolded:
        fold = stacked["fold"]
        B, R, Cf = x.shape
        if Cf % fold:
            raise ValueError(f"mrf_stack_folded: last dim {Cf} is not a "
                             f"multiple of the fold {fold}")
        x = x.reshape(B, R * fold, Cf // fold)
    if x.device.type == "cpu":
        return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack_folded: no kernel for device {x.device}")
    out, n = _launch(upcast(x), stacked, tuple(kernel_sizes), tuple(dilations))
    mrf_stack_folded.launches += n
    return out.to(x.dtype)


mrf_stack_folded.launches = 0


def _streamed_lib():
    lib = cuda_build.library("mrf_stack_streamed")
    lib.mrf_stack_streamed_bf16.restype = ctypes.c_int
    lib.mrf_stack_streamed_bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p] * 3)
    lib.mrf_stack_streamed_plan.restype = ctypes.c_int
    lib.mrf_stack_streamed_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.mrf_stack_streamed_flops.restype = ctypes.c_double
    lib.mrf_stack_streamed_flops.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return lib


def streamed_plan(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda"):
    """The whole-stage kernel's launch plan at B, T on `device`: `tile`
    (frames per cluster, the fewest that put every cluster on the card at
    once), `resident` (clusters the card holds at once), `slab` (floats of
    device memory for the CTAs' y), `smem` (bytes of shared memory per CTA)
    and `cluster` (CTAs per cluster)."""
    plan = (ctypes.c_int * 5)()
    lib = _streamed_lib()
    with torch.cuda.device(device):
        err = lib.mrf_stack_streamed_plan(B, T, len(kernel_sizes), len(dilations),
                                          _int_array(kernel_sizes), _int_array(dilations),
                                          ctypes.cast(plan, ctypes.c_void_p))
    cuda_build.check(lib, "mrf_stack_streamed", err)
    return dict(zip(("tile", "resident", "slab", "smem", "cluster"), plan))


def streamed_flops(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda"):
    """FLOPs the whole-stage kernel executes at B, T on `device`, halo
    recompute included (the kernel's own count of its passes)."""
    tile = streamed_plan(B, T, kernel_sizes, dilations, device)["tile"]
    return _streamed_lib().mrf_stack_streamed_flops(
        B, T, tile, len(kernel_sizes), len(dilations), _int_array(kernel_sizes),
        _int_array(dilations))


def mrf_stack_streamed(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """A whole MRF stage at C = 256 in one launch: x [B, T, C], stacked
    from `stack_mrf_params` with every branch -> the averaged MRF output
    [B, T, C], as `mrf_stack`.

    CUDA tensors run `csrc/mrf_stack_streamed.cu`, a bf16 tensor-core kernel
    in clusters of 4 CTAs that split the output channels (counted in `mrf_stack_streamed.launches`), on the
    weights of `kernel_weights` for the whole stage (fp32 weights are cast
    per call); CPU tensors run the plain version in the weights' type.  bf16
    x is upcast, and the output comes back in x's type."""
    if x.device.type == "cpu":
        return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack_streamed: no kernel for device {x.device}")
    dtype, x = x.dtype, upcast(x)
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    stacked = _mma_weights("mrf_stack_streamed", x, stacked, kernel_sizes, dilations, (256,))
    B, T, C = x.shape
    plan = streamed_plan(B, T, kernel_sizes, dilations, x.device)
    lib = _streamed_lib()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        slab = torch.empty(plan["slab"], dtype=torch.float32, device=x.device)
        err = lib.mrf_stack_streamed_bf16(
            x.data_ptr(), out.data_ptr(), slab.data_ptr(),
            stacked["w1_mma"].data_ptr(), stacked["b1"].data_ptr(),
            stacked["w2_mma"].data_ptr(), stacked["b2"].data_ptr(), B, T, C, plan["tile"],
            len(kernel_sizes), len(dilations), _int_array(kernel_sizes),
            _int_array(dilations), torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "mrf_stack_streamed", err)
    mrf_stack_streamed.launches += 1
    return out.to(dtype)


mrf_stack_streamed.launches = 0
