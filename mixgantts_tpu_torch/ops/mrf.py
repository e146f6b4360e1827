"""HiFi-GAN's multi-receptive-field (MRF) stage: CUDA kernels and plain
version.

Counterpart of `mixgantts_tpu/ops/pallas_vocoder.py` (`mrf_stack`,
`mrf_stack_folded`, `mrf_stack_streamed`, `stack_mrf_params`,
`stack_mrf_params_folded`).  For each branch (kernel k), a chain of
residual pairs leaky_relu -> dilated conv -> leaky_relu -> conv, added to
the branch input; the stage returns the mean of the branch outputs.  Convolutions use zero
("SAME") padding.

Shapes: the TPU kernels' own.  Every odd kernel size up to TAPS = 11 (the
taps are centred in 11, which is SAME padding only for an odd k), any
number of branches and pairs, and any dilation schedule whose creep fits the
TPU kernels' halo: sum over pairs of (k // 2) * (d + 1) <= HALO = 64 for
every branch (V1's (3, 7, 11) x (1, 3, 5): 12, 36 and 60).  `_check` raises
on anything else, naming the limit.

Stacked weights keep the JAX package's layout: w1/w2 [n_br, n_pair, 11, C,
C] (taps centred in 11, then input channel, output channel), b1/b2
[n_br, n_pair, C].  The time-folded layout of the TPU kernel holds the same
bytes as a contiguous [B, T, C] tensor, so `mrf_stack_folded` views it as
such.  Which CUDA kernel runs a stage follows from its width alone
(`route`), for both entry points:
- C <= 16: `csrc/mrf_stage_narrow.cu`, the whole stage in one launch (a
  block per tile of frames runs every branch and pair with y in shared
  memory; x read once, the output written once), at the next of
  NARROW_WIDTHS (8, 16);
- 16 < C <= 256: `csrc/mrf_stack.cu`'s pair kernel, one launch per branch
  and pair, at 32, 64, 128 or 256 (at 32 and 64 it is faster than the
  whole-stage design, whose shared-memory phases and halo recompute cost
  more there than the pair kernel's device-memory traffic: the source's
  header);
- 256 < C <= 512: the same file's wide kernel, two launches a pair, at 512.
`mrf_stack_streamed` runs a whole stage of 128 < C <= 512 in one launch
(`csrc/mrf_stack_streamed.cu` at 256 or 512, a tile of frames per cluster
of C / 64 CTAs that split the output channels).

Arithmetic follows the weights' type, as the TPU kernels' operand type
does (`op_dtype = w1_ref.dtype`): fp32 weights compute in fp32; bf16
weights round the stage input and every conv input to bf16, accumulate in
fp32 and keep biases, residual and branch mean in fp32.  On the TPU the
JAX package always casts the weights to bf16, and so do the three entry
points on CUDA: the three sources are bf16 tensor-core kernels, fed by
`kernel_weights`.

The signal x may be fp32 or bf16 (a vocoder computing in bf16, as the TPU
kernels read it under the JAX package's bf16 compute): bf16 is upcast
exactly into the fp32-input kernels and plain version, and the output comes
back in x's type.

Widths: the TPU kernels take any C.  The kernels are built for C in
KERNEL_WIDTHS (wgmma's N is the whole channel axis, a multiple of 8, up to
256; at 512 a block owns one half of it), so a stage of any C <= 512 runs
at the next of them, Cp, with zero channels above C (`kernel_width`,
`pad_mrf_width`, `pad_channels`), and the output is cut back to C.  The
zero channels are exact: leaky_relu(0) = 0, and zero weights and biases
keep them zero and add nothing to the fp32 sums of the real channels.  The
weights are padded once, in `kernel_weights` (the keys the kernels read:
`w1_mma`, `w2_mma`, `b1_mma`, `b2_mma`); x comes at Cp per call.  Wider
than 512 raises, naming the limit: the TPU kernels keep a stage's stacked
weights [n_br, n_pair, 11, C, C] resident, 138 MB of bf16 for one branch at
C = 1024, which no TPU core holds, so no TPU kernel takes such a stage.
The whole-stage kernel (`mrf_stack_streamed`) runs 128 < C <= 256 at 256
and 256 < C <= 512 at 512 (`streamed_width`), every schedule within the
halo (`streamed_plan`); the narrow kernel plans its tile per schedule
(`narrow_plan`), every schedule within the halo.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import cuda_build

LRELU_SLOPE = 0.1
TAPS = 11  # every kernel is zero-padded to the largest (k = 11)
HALO = 64  # frames a side the TPU kernels' tiles carry: the largest creep
NARROW_WIDTHS = (8, 16)                   # the C csrc/mrf_stage_narrow.cu is built for
PAIR_WIDTHS = (32, 64, 128, 256, 512)     # the C csrc/mrf_stack.cu is built for
KERNEL_WIDTHS = NARROW_WIDTHS + PAIR_WIDTHS
STREAMED_WIDTHS = (256, 512)              # the C csrc/mrf_stack_streamed.cu is built for
MAX_SMEM = 232448  # dynamic shared memory an H100 block may hold
SPLIT = 256        # output channels of one run of the packed weights (wgmma's largest N)


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


def pad_channels(t, Cp):
    """t [..., C] with zero channels appended up to [..., Cp] (t itself
    where C = Cp)."""
    return t if t.shape[-1] == Cp else F.pad(t, (0, Cp - t.shape[-1]))


def kernel_width(C):
    """The width Cp at which the CUDA kernels run a C-channel stage: the
    least of KERNEL_WIDTHS that is >= C (`csrc/mrf_stage_narrow.cu` up to
    16, `csrc/mrf_stack.cu` above).  Raises above the widest."""
    for Cp in KERNEL_WIDTHS:
        if C <= Cp:
            return Cp
    raise ValueError(f"mrf_stack kernel: C={C}; it takes C <= {KERNEL_WIDTHS[-1]}")


def route(C):
    """The CUDA kernel that runs a C-channel stage from `mrf_stack` or
    `mrf_stack_folded`: "mrf_stage_narrow" (the whole stage in one launch)
    for C <= 16, "mrf_pair_mma" (one launch per branch and pair) up to 256,
    "mrf_wide_mma" (two launches a pair) up to 512.  Raises above."""
    Cp = kernel_width(C)
    if Cp in NARROW_WIDTHS:
        return "mrf_stage_narrow"
    return "mrf_pair_mma" if Cp <= SPLIT else "mrf_wide_mma"


def stage_launches(C, n_br, n_pair):
    """Kernel launches of one `mrf_stack` / `mrf_stack_folded` call of n_br
    branches of n_pair pairs at width C: one for the whole stage at C <= 16,
    else `pair_launches` per branch and pair."""
    if route(C) == "mrf_stage_narrow":
        return 1
    return n_br * n_pair * pair_launches(C)


def packed_taps(Cp):
    """Elements of one (branch, pair)'s packed weights at width Cp: 11 taps of
    Cp input channels, K rounded up to a 16-deep step, times Cp outputs."""
    return -(-TAPS * Cp // 16) * 16 * Cp


def streamed_width(C):
    """The width at which `csrc/mrf_stack_streamed.cu` runs a C-channel
    stage: 256 for 128 < C <= 256, 512 for 256 < C <= 512 (the TPU
    function's stages above 128).  Raises elsewhere."""
    if C > 128:
        for Cp in STREAMED_WIDTHS:
            if C <= Cp:
                return Cp
    raise ValueError(f"mrf_stack_streamed kernel: C={C}; it takes 128 < C <= "
                     f"{STREAMED_WIDTHS[-1]} (mrf_stack takes the narrower stages)")


def creep(k, dilations):
    """Frames a side by which a kernel-k branch of `dilations` widens what
    it reads: sum over pairs of (k // 2) * (d + 1)."""
    return sum((k // 2) * (d + 1) for d in dilations)


def pad_mrf_width(stacked, Cp):
    """Stacked weights of width C -> width Cp >= C with zero channels:
    w1/w2 [n_br, n_pair, 11, Cp, Cp] (both channel axes), b1/b2 [n_br,
    n_pair, Cp].  The stage at Cp of x padded so (`pad_channels`) equals
    the stage at C on its first C channels; the others stay zero."""
    C = stacked["b1"].shape[-1]
    return dict(stacked, **{k: F.pad(stacked[k], (0, Cp - C, 0, Cp - C)) for k in ("w1", "w2")},
                **{k: pad_channels(stacked[k], Cp) for k in ("b1", "b2")})


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
    """[n_br, n_pair, 11, C, C] -> bf16 [n_br, n_pair, packed_taps(C)]: each
    (branch, pair) holds its k real taps first, flattened to K = tap * C +
    input channel, zero rows up to a multiple of 16 (k C at C = 8 and odd k)
    and laid out in the order `csrc/mrf_mma.cuh` reads it: per 16-deep K
    slab s, per group g of 8 output channels, per half h of the slab, an 8 x
    8 core matrix [output channel % 8][K % 8].  Above SPLIT output channels
    the output axis splits into runs of SPLIT (z), each the whole K axis in
    that order, run after run: a block that owns one run's channels reads one
    contiguous stretch."""
    n_br, n_pair, _, C, _ = w.shape
    n = min(C, SPLIT)
    out = torch.zeros(n_br, n_pair, packed_taps(C), dtype=torch.bfloat16, device=w.device)
    for br, rk in enumerate(kernel_sizes):
        pad = (TAPS - rk) // 2
        K = -(-rk * C // 16) * 16
        t = w[br, :, pad:pad + rk].to(torch.bfloat16).reshape(n_pair, rk * C, C)
        t = F.pad(t, (0, 0, 0, K - rk * C))                            # [p, K, c_out]
        t = t.reshape(n_pair, K // 16, 2, 8, C // n, n // 8, 8)         # [p, s, h, e, z, g, r]
        out[br, :, :K * C] = t.permute(0, 4, 1, 5, 2, 6, 3).reshape(n_pair, -1)
    return out


def kernel_weights(stacked, kernel_sizes=(3, 7, 11)):
    """Stacked weights as the CUDA kernels take them.  The stack itself,
    for the plain version: w1/w2 in bf16 (the TPU kernel's operand type,
    `pallas_vocoder.py:535-539`), b1/b2 in fp32.  And, where C <= 512, the
    kernel's own tensors at its width Cp (`kernel_width`; zero channels
    above C, `pad_mrf_width`): the bf16 copies `w1_mma`/`w2_mma` in the
    kernel's order for `kernel_sizes`, and `b1_mma`/`b2_mma` in fp32.
    `models.hifigan.fused_apply` makes them once per stage; the entry
    points make them per call for weights that lack them."""
    w1 = stacked["w1"].to(torch.bfloat16).contiguous()
    w2 = stacked["w2"].to(torch.bfloat16).contiguous()
    out = dict(stacked, w1=w1, w2=w2,
               b1=stacked["b1"].float().contiguous(), b2=stacked["b2"].float().contiguous())
    C = out["b1"].shape[-1]
    if C <= KERNEL_WIDTHS[-1]:
        padded = pad_mrf_width(out, kernel_width(C))
        out.update(w1_mma=_pack_taps(padded["w1"], kernel_sizes),
                   w2_mma=_pack_taps(padded["w2"], kernel_sizes),
                   b1_mma=padded["b1"].contiguous(), b2_mma=padded["b2"].contiguous(),
                   mma_kernel_sizes=tuple(kernel_sizes))
    return out


def _check(name, x, stacked, kernel_sizes, dilations):
    """Raise unless a CUDA kernel takes x [B, T, C] (fp32) and the stacked
    weights (bf16 or fp32; `kernel_weights` casts them) as they are: the TPU
    kernels' shapes (every odd k <= 11, a schedule within the halo) at a
    width the kernels run."""
    B, T, C = x.shape
    n_br, n_pair = len(kernel_sizes), len(dilations)
    if not n_br or not n_pair:
        raise ValueError(f"{name} kernel: {n_br} branches of {n_pair} pairs; it takes at "
                         "least one of each")
    if any(k not in range(1, TAPS + 1, 2) for k in kernel_sizes):
        raise ValueError(f"{name} kernel: kernel sizes {kernel_sizes}; it takes odd k <= "
                         f"{TAPS} (the taps are centred in {TAPS}, which is SAME padding "
                         "only for an odd k)")
    if any(int(d) != d or d < 1 for d in dilations):
        raise ValueError(f"{name} kernel: dilations {dilations}; they must be integers >= 1")
    for k in kernel_sizes:
        if creep(k, dilations) > HALO:
            raise ValueError(
                f"{name} kernel: kernel size {k} with dilations {dilations} creeps "
                f"{creep(k, dilations)} frames a side, past the {HALO}-frame halo of the TPU "
                f"kernels (sum over pairs of (k // 2) * (d + 1) <= {HALO})")
    kernel_width(C)
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


def _mma_weights(name, x, stacked, kernel_sizes, dilations, Cp):
    """Check x and the stacked weights for a bf16 CUDA kernel running at
    width Cp and return them with the kernel's own tensors
    (`kernel_weights`, made for this call where fp32 weights lack them);
    raise on what the kernel does not take."""
    _check(name, x, stacked, kernel_sizes, dilations)
    if "w1_mma" not in stacked:
        stacked = kernel_weights(stacked, kernel_sizes)
    packed = (len(kernel_sizes), len(dilations), packed_taps(Cp))
    bias = (len(kernel_sizes), len(dilations), Cp)
    if (stacked["mma_kernel_sizes"] != kernel_sizes
            or any(stacked[k].shape != packed or stacked[k].dtype != torch.bfloat16
                   or stacked[k].device != x.device for k in ("w1_mma", "w2_mma"))
            or any(stacked[k].shape != bias or stacked[k].dtype != torch.float32
                   or stacked[k].device != x.device for k in ("b1_mma", "b2_mma"))):
        raise ValueError(f"{name} kernel: w1_mma/w2_mma must be bf16 {packed} on "
                         f"{x.device}, laid out for kernel sizes {kernel_sizes}, and "
                         f"b1_mma/b2_mma fp32 {bias}; make them with kernel_weights")
    return stacked


def smem_bytes(Cp, k, dilation):
    """Dynamic shared memory of the largest block `csrc/mrf_stack.cu`
    launches for one pair at width Cp, kernel size k and a dilation (the
    library's own reckoning, `mrf_stack_smem_bytes`)."""
    lib = cuda_build.library("mrf_stack")
    lib.mrf_stack_smem_bytes.restype = ctypes.c_int
    lib.mrf_stack_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib.mrf_stack_smem_bytes(Cp, k, dilation)


def pair_launches(C):
    """Kernel launches of one residual pair at width C: two at the width
    whose blocks split the output channels (conv1's output through device
    memory), else one."""
    return 2 if kernel_width(C) > SPLIT else 1


def _launch(x, stacked, kernel_sizes, dilations):
    """Run csrc/mrf_stack.cu on a CUDA x [B, T, C] (fp32, 16 < C <= 512)
    with bf16 operands, at the kernel's width Cp (`kernel_width`: x with
    zero channels above C, the output cut back to C); fp32 weights are cast
    (`kernel_weights`) for this call.  Returns (out, launches)."""
    B, T, C = x.shape
    Cp = kernel_width(C)
    n_br, n_pair = len(kernel_sizes), len(dilations)
    stacked = _mma_weights("mrf_stack", x, stacked, kernel_sizes, dilations, Cp)
    for k in kernel_sizes:
        for d in dilations:
            smem = smem_bytes(Cp, k, d)
            if not 0 < smem <= MAX_SMEM:
                raise ValueError(f"mrf_stack kernel: C={Cp}, k={k}, d={d} needs {smem} B of "
                                 f"shared memory a block; the card holds {MAX_SMEM}")
    lib = cuda_build.library("mrf_stack")
    fn = lib.mrf_stack_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    ks, ds = _int_array(kernel_sizes), _int_array(dilations)
    with torch.cuda.device(x.device):
        xp = pad_channels(x, Cp).contiguous()
        out = torch.empty_like(xp)
        buf0 = torch.empty_like(xp)
        buf1 = torch.empty_like(xp)
        hbuf = torch.empty_like(xp, dtype=torch.bfloat16) if Cp > SPLIT else None
        err = fn(xp.data_ptr(), out.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
                 None if hbuf is None else hbuf.data_ptr(),
                 stacked["w1_mma"].data_ptr(), stacked["b1_mma"].data_ptr(),
                 stacked["w2_mma"].data_ptr(), stacked["b2_mma"].data_ptr(), B, T, Cp, n_br,
                 n_pair, ks, ds, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(lib, "mrf_stack", err)
    return (out if Cp == C else out[..., :C].contiguous()), n_br * n_pair * pair_launches(C)


def tile_frames(C, k):
    """Output frames one block of the pair kernel owns at width C (32 to
    512) and kernel size k (blocks per launch = B * ceil(T / frames))."""
    lib = cuda_build.library("mrf_stack")
    lib.mrf_stack_tile_frames.restype = ctypes.c_int
    lib.mrf_stack_tile_frames.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib.mrf_stack_tile_frames(C, k)


def _narrow_lib():
    lib = cuda_build.library("mrf_stage_narrow")
    lib.mrf_stage_narrow_bf16.restype = ctypes.c_int
    lib.mrf_stage_narrow_bf16.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p] * 3)
    lib.mrf_stage_narrow_plan.restype = ctypes.c_int
    lib.mrf_stage_narrow_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    lib.mrf_stage_narrow_smem_bytes.restype = ctypes.c_int
    lib.mrf_stage_narrow_smem_bytes.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                                                + [ctypes.c_int, ctypes.c_void_p])
    lib.mrf_stage_narrow_flops.restype = ctypes.c_double
    lib.mrf_stage_narrow_flops.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    return lib


def narrow_smem_bytes(C, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), tile=None):
    """The narrow kernel's reckoning at width C (<= 16, run at
    `kernel_width`) for a schedule, with no device: (bytes of shared memory
    a block takes at `tile` frames, the longest tile whose every window fits
    one pass and the card's shared memory); `tile` None is that longest."""
    Cp = kernel_width(C)
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    got = (ctypes.c_int * 2)()
    lib = _narrow_lib()
    args = (Cp, len(kernel_sizes), len(dilations), _int_array(kernel_sizes),
            _int_array(dilations))
    err = lib.mrf_stage_narrow_smem_bytes(*args, 1, ctypes.cast(got, ctypes.c_void_p))
    cuda_build.check(lib, "mrf_stage_narrow", err)
    if tile is None:
        tile = got[1]
        err = lib.mrf_stage_narrow_smem_bytes(*args, tile, ctypes.cast(got, ctypes.c_void_p))
        cuda_build.check(lib, "mrf_stage_narrow", err)
    return got[0], tile


def narrow_plan(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda", C=16):
    """The narrow kernel's launch plan at B, T and width C (<= 16, run at
    `kernel_width`) on `device`: `tile` (output frames per block: the
    longest whose windows fit one pass and the shared memory, shortened to
    fill whole waves of resident blocks), `blocks` (per launch), `resident`
    (blocks the card holds at once), `smem` (bytes of shared memory per
    block), `rows` (rows of a pass) and `lead` (frames of halo a side, the
    widest creep).  Raises where the kernel does not take the schedule."""
    Cp = kernel_width(C)
    if Cp not in NARROW_WIDTHS:
        raise ValueError(f"mrf_stage_narrow kernel: C={C}; it takes C <= {NARROW_WIDTHS[-1]}")
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    plan = (ctypes.c_int * 6)()
    lib = _narrow_lib()
    with torch.cuda.device(device):
        err = lib.mrf_stage_narrow_plan(B, T, Cp, len(kernel_sizes), len(dilations),
                                        _int_array(kernel_sizes), _int_array(dilations),
                                        ctypes.cast(plan, ctypes.c_void_p))
    cuda_build.check(lib, "mrf_stage_narrow", err)
    plan = dict(zip(("tile", "blocks", "resident", "smem", "rows", "lead"), plan))
    if not plan["tile"]:
        raise ValueError(
            f"mrf_stage_narrow kernel: C={Cp} with kernel sizes {kernel_sizes} and dilations "
            f"{dilations} fits no tile: {plan['smem']} B of shared memory a block at one frame; "
            f"the card holds {MAX_SMEM}")
    return plan


def narrow_flops(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda", C=16):
    """FLOPs the narrow kernel executes at B, T and width C on `device`: the
    64-row tiles of every conv, halo recompute and K's padding to 16
    included, at the width it runs."""
    tile = narrow_plan(B, T, kernel_sizes, dilations, device, C)["tile"]
    return _narrow_lib().mrf_stage_narrow_flops(
        B, T, kernel_width(C), tile, len(kernel_sizes), len(dilations),
        _int_array(tuple(kernel_sizes)), _int_array(tuple(dilations)))


def narrow_stage(x, stacked, kernel_sizes, dilations):
    """Run csrc/mrf_stage_narrow.cu on a CUDA x [B, T, C] (fp32, C <= 16):
    the whole stage in one launch, at the kernel's width Cp (`kernel_width`:
    x with zero channels above C, the output cut back to C), counted in
    `narrow_stage.launches` (as well as in the entry point's count); fp32
    weights are cast (`kernel_weights`) for this call.  Returns (out, 1)."""
    with span("kernel.narrow_stage"):
        B, T, C = x.shape
        Cp = kernel_width(C)
        stacked = _mma_weights("mrf_stage_narrow", x, stacked, kernel_sizes, dilations, Cp)
        plan = narrow_plan(B, T, kernel_sizes, dilations, x.device, C)
        if not 0 < plan["smem"] <= MAX_SMEM:
            raise ValueError(f"mrf_stage_narrow kernel: C={Cp} needs {plan['smem']} B of "
                             f"shared memory a block; the card holds {MAX_SMEM}")
        lib = _narrow_lib()
        with torch.cuda.device(x.device):
            xp = pad_channels(x, Cp).contiguous()
            out = torch.empty_like(xp)
            err = lib.mrf_stage_narrow_bf16(
                xp.data_ptr(), out.data_ptr(), stacked["w1_mma"].data_ptr(),
                stacked["b1_mma"].data_ptr(), stacked["w2_mma"].data_ptr(),
                stacked["b2_mma"].data_ptr(), B, T, Cp, plan["tile"], len(kernel_sizes),
                len(dilations), _int_array(kernel_sizes), _int_array(dilations),
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(lib, "mrf_stage_narrow", err)
        narrow_stage.launches += 1
        return (out if Cp == C else out[..., :C].contiguous()), 1


narrow_stage.launches = 0


def _run(name, x, stacked, kernel_sizes, dilations):
    """The stage on a CUDA x through the kernel of its width (`route`):
    (out in x's type, launches)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    launch = narrow_stage if route(x.shape[-1]) == "mrf_stage_narrow" else _launch
    out, n = launch(upcast(x), stacked, kernel_sizes, dilations)
    return out.to(x.dtype), n


def mrf_stack(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """x [B, T, C], stacked from `stack_mrf_params` -> the averaged MRF
    output [B, T, C].

    CUDA tensors run the hand-written bf16 tensor-core kernel of the width
    (`route`; any C <= 512, at `kernel_width`), counted in
    `mrf_stack.launches` (`stage_launches`: one for the whole stage at
    C <= 16, else one per branch and pair, two at C > 256), on the weights
    of `kernel_weights` (fp32 weights are cast per call); CPU tensors run
    the plain version in the weights' type.  bf16 x is upcast, and the
    output comes back in x's type."""
    with span("kernel.mrf_stack"):
        if x.device.type == "cpu":
            return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
        out, n = _run("mrf_stack", x, stacked, kernel_sizes, dilations)
        mrf_stack.launches += n
        return out


mrf_stack.launches = 0


def mrf_stack_folded(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5),
                     prefolded=False):
    """The MRF stage for the narrow stages (C = 64 and 32 in HiFi-GAN V1,
    64 down to 8 in V2).

    prefolded=True takes x in the TPU kernel's folded layout [B, T/F, F*C]
    (x_folded[b, i, f*C + c] == x[b, F*i + f, c]), which is a view of the
    contiguous [B, T, C] signal; otherwise x is [B, T, C].  Returns
    [B, T, C] in x's type.  CUDA tensors run the kernel of the width, as
    `mrf_stack` (at C <= 16 `csrc/mrf_stage_narrow.cu`, the whole stage in
    one launch), counted in `mrf_stack_folded.launches`; CPU tensors run the
    plain version."""
    with span("kernel.mrf_stack_folded"):
        if prefolded:
            fold = stacked["fold"]
            B, R, Cf = x.shape
            if Cf % fold:
                raise ValueError(f"mrf_stack_folded: last dim {Cf} is not a "
                                 f"multiple of the fold {fold}")
            x = x.reshape(B, R * fold, Cf // fold)
        if x.device.type == "cpu":
            return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
        out, n = _run("mrf_stack_folded", x, stacked, kernel_sizes, dilations)
        mrf_stack_folded.launches += n
        return out


mrf_stack_folded.launches = 0


def _streamed_lib():
    lib = cuda_build.library("mrf_stack_streamed")
    lib.mrf_stack_streamed_bf16.restype = ctypes.c_int
    lib.mrf_stack_streamed_bf16.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p] * 3)
    lib.mrf_stack_streamed_plan.restype = ctypes.c_int
    lib.mrf_stack_streamed_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    lib.mrf_stack_streamed_flops.restype = ctypes.c_double
    lib.mrf_stack_streamed_flops.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    return lib


def streamed_plan(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda", C=256):
    """The whole-stage kernel's launch plan at B, T and width C (run at
    `streamed_width(C)`) on `device`: `tile` (frames per cluster, the fewest
    that put every cluster on the card at once), `resident` (clusters the
    card holds at once), `slab` (floats of device memory for the CTAs' y),
    `smem` (bytes of shared memory per CTA), `cluster` (CTAs per cluster),
    `rows` (rows a pass: 64 per warpgroup that fits), `stages` (of the
    weight ring: 4, or 2 where y is updated out of place) and `pingpong` (1
    where y is updated out of place, in two slabs: at 512 where the
    in-place plan does not fit, as past a conv1 reach of 43 frames).  Every
    schedule within the halo has a plan (the arithmetic is in the source's
    header); raises where the kernel does not take the schedule."""
    Cp = streamed_width(C)
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    plan = (ctypes.c_int * 8)()
    lib = _streamed_lib()
    with torch.cuda.device(device):
        err = lib.mrf_stack_streamed_plan(B, T, Cp, len(kernel_sizes), len(dilations),
                                          _int_array(kernel_sizes), _int_array(dilations),
                                          ctypes.cast(plan, ctypes.c_void_p))
    cuda_build.check(lib, "mrf_stack_streamed", err)
    plan = dict(zip(("tile", "resident", "slab", "smem", "cluster", "rows", "stages",
                     "pingpong"), plan))
    if not plan["rows"]:
        reach = max((k // 2) * d for k in kernel_sizes for d in dilations)
        raise ValueError(
            f"mrf_stack_streamed kernel: C={Cp} with kernel sizes {kernel_sizes} and "
            f"dilations {dilations} (a conv1 reach of {reach} frames) needs {plan['smem']} B "
            f"of shared memory a CTA at one 64-row pass; the card holds {MAX_SMEM}")
    return plan


def streamed_flops(B, T, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5), device="cuda", C=256):
    """FLOPs the whole-stage kernel executes at B, T and width C on
    `device`, halo recompute included (the kernel's own count of its
    passes), at the width it runs."""
    tile = streamed_plan(B, T, kernel_sizes, dilations, device, C)["tile"]
    return _streamed_lib().mrf_stack_streamed_flops(
        B, T, streamed_width(C), tile, len(kernel_sizes), len(dilations),
        _int_array(kernel_sizes), _int_array(dilations))


def mrf_stack_streamed(x, stacked, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """A whole MRF stage of 128 < C <= 512 in one launch: x [B, T, C],
    stacked from `stack_mrf_params` with every branch -> the averaged MRF
    output [B, T, C], as `mrf_stack`.

    CUDA tensors run `csrc/mrf_stack_streamed.cu`, a bf16 tensor-core kernel
    in clusters of Cp / 64 CTAs that split the output channels (counted in
    `mrf_stack_streamed.launches`), at Cp = `streamed_width(C)` with zero
    channels above C, on the weights of `kernel_weights` for the whole stage
    (fp32 weights are cast per call); CPU tensors run the plain version in
    the weights' type.  bf16 x is upcast, and the output comes back in x's
    type."""
    with span("kernel.mrf_stack_streamed"):
        if x.device.type == "cpu":
            return mrf_stack_plain(x, stacked, kernel_sizes, dilations)
        if x.device.type != "cuda":
            raise ValueError(f"mrf_stack_streamed: no kernel for device {x.device}")
        dtype, x = x.dtype, upcast(x)
        kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
        B, T, C = x.shape
        Cp = streamed_width(C)
        stacked = _mma_weights("mrf_stack_streamed", x, stacked, kernel_sizes, dilations, Cp)
        plan = streamed_plan(B, T, kernel_sizes, dilations, x.device, C)
        lib = _streamed_lib()
        with torch.cuda.device(x.device):
            xp = pad_channels(x, Cp).contiguous()
            out = torch.empty_like(xp)
            slab = torch.empty(plan["slab"], dtype=torch.float32, device=x.device)
            err = lib.mrf_stack_streamed_bf16(
                xp.data_ptr(), out.data_ptr(), slab.data_ptr(),
                stacked["w1_mma"].data_ptr(), stacked["b1_mma"].data_ptr(),
                stacked["w2_mma"].data_ptr(), stacked["b2_mma"].data_ptr(), B, T, Cp,
                plan["tile"], len(kernel_sizes), len(dilations), _int_array(kernel_sizes),
                _int_array(dilations), torch.cuda.current_stream().cuda_stream)
            cuda_build.check(lib, "mrf_stack_streamed", err)
        mrf_stack_streamed.launches += 1
        return (out if Cp == C else out[..., :C].contiguous()).to(dtype)


mrf_stack_streamed.launches = 0
