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
launch (`csrc/mrf_stack_streamed.cu`).
"""

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


def mrf_stack_plain(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """The MRF stage in plain PyTorch (F.conv1d), any device.
    x [B, T, C] -> [B, T, C]."""
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
    return (acc / len(kernel_sizes)).transpose(1, 2)


def _check(name, x, stacked, kernel_sizes, dilations, widths):
    """Raise unless a CUDA kernel takes x [B, T, C] and the stacked weights
    as they are."""
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
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {key} must be contiguous float32 "
                             f"on {x.device}, got {t.dtype} on {t.device}")
        if key != "x" and tuple(t.shape) != want[key]:
            raise ValueError(f"{name} kernel: {key} has shape "
                             f"{tuple(t.shape)}, want {want[key]}")


def _int_array(values):
    """A host int array as a pointer argument (the pointer keeps it alive)."""
    return ctypes.cast((ctypes.c_int * len(values))(*values), ctypes.c_void_p)


def _launch(x, stacked, kernel_sizes, dilations):
    """Run csrc/mrf_stack.cu on a CUDA x [B, T, C]; returns (out, launches)."""
    B, T, C = x.shape
    n_br, n_pair = len(kernel_sizes), len(dilations)
    _check("mrf_stack", x, stacked, kernel_sizes, dilations, (32, 64, 128, 256))
    lib = cuda_build.library("mrf_stack")
    fn = lib.mrf_stack_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    ks, ds = _int_array(kernel_sizes), _int_array(dilations)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
                 stacked["w1"].data_ptr(), stacked["b1"].data_ptr(),
                 stacked["w2"].data_ptr(), stacked["b2"].data_ptr(), B, T, C, n_br, n_pair,
                 ks, ds, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "mrf_stack", err)
    return out, n_br * n_pair


def mrf_stack(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """x [B, T, C], stacked from `stack_mrf_params` -> the averaged MRF
    output [B, T, C].

    CUDA tensors run the hand-written kernel (one launch per branch and
    pair, counted in `mrf_stack.launches`); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack: no kernel for device {x.device}")
    out, n = _launch(x, stacked, tuple(kernel_sizes), tuple(dilations))
    mrf_stack.launches += n
    return out


mrf_stack.launches = 0


def mrf_stack_folded(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                     prefolded=False):
    """The MRF stage for the narrow stages (C = 64 and 32 in HiFi-GAN V1).

    prefolded=True takes x in the TPU kernel's folded layout [B, T/F, F*C]
    (x_folded[b, i, f*C + c] == x[b, F*i + f, c]), which is a view of the
    contiguous [B, T, C] signal; otherwise x is [B, T, C].  Returns
    [B, T, C].  CUDA tensors run the same kernel as `mrf_stack`, counted in
    `mrf_stack_folded.launches`; CPU tensors run the plain version."""
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
    out, n = _launch(x, stacked, tuple(kernel_sizes), tuple(dilations))
    mrf_stack_folded.launches += n
    return out


mrf_stack_folded.launches = 0


STREAMED_PASS = 64   # output frames of one pass of the whole-stage kernel


def streamed_tile(B, T, device):
    """Frames per block of the whole-stage kernel: the smallest multiple of
    STREAMED_PASS that gives at most one block per SM (a block takes a whole
    SM's shared memory), so the card is filled with the least halo."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    passes = -(-T // STREAMED_PASS)
    return STREAMED_PASS * -(-(B * passes) // n_sm)


def _streamed_lib():
    lib = cuda_build.library("mrf_stack_streamed")
    lib.mrf_stack_streamed_f32.restype = ctypes.c_int
    lib.mrf_stack_streamed_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                           + [ctypes.c_void_p] * 3)
    lib.mrf_stack_streamed_slab_rows.restype = ctypes.c_int
    lib.mrf_stack_streamed_slab_rows.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mrf_stack_streamed_flops.restype = ctypes.c_double
    lib.mrf_stack_streamed_flops.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    return lib


def streamed_flops(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda"):
    """FLOPs the whole-stage kernel executes at B, T on `device`, halo
    recompute included (the kernel's own count)."""
    ks, ds = _int_array(kernel_sizes), _int_array(dilations)
    return _streamed_lib().mrf_stack_streamed_flops(
        B, T, streamed_tile(B, T, device), len(kernel_sizes), len(dilations), ks, ds)


def mrf_stack_streamed(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """A whole MRF stage at C = 256 in one launch: x [B, T, C], stacked
    from `stack_mrf_params` with every branch -> the averaged MRF output
    [B, T, C], as `mrf_stack`.

    CUDA tensors run `csrc/mrf_stack_streamed.cu` (counted in
    `mrf_stack_streamed.launches`); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stack_streamed: no kernel for device {x.device}")
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    _check("mrf_stack_streamed", x, stacked, kernel_sizes, dilations, (256,))
    B, T, C = x.shape
    lib = _streamed_lib()
    ks, ds = _int_array(kernel_sizes), _int_array(dilations)
    tile = streamed_tile(B, T, x.device)
    rows = lib.mrf_stack_streamed_slab_rows(tile, len(kernel_sizes), len(dilations), ks, ds)
    if rows < 0:
        raise ValueError(f"mrf_stack_streamed kernel: no plan for tile {tile}, "
                         f"kernel sizes {kernel_sizes}, dilations {dilations}")
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        slab = torch.empty(2, B * -(-T // tile) * rows * C, dtype=torch.float32,
                           device=x.device)
        err = lib.mrf_stack_streamed_f32(
            x.data_ptr(), out.data_ptr(), slab[0].data_ptr(), slab[1].data_ptr(),
            stacked["w1"].data_ptr(), stacked["b1"].data_ptr(),
            stacked["w2"].data_ptr(), stacked["b2"].data_ptr(), B, T, C, tile,
            len(kernel_sizes), len(dilations), ks, ds,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "mrf_stack_streamed", err)
    mrf_stack_streamed.launches += 1
    return out


mrf_stack_streamed.launches = 0
