"""Where the denoiser kernel's time goes, on one CUDA device (it needs the
card and nvcc; no JAX).

    python3 tests/bench_torch_denoiser.py phases
    python3 tests/bench_torch_denoiser.py variants NAME=SPEC [NAME=SPEC ...]

`phases` builds `csrc/denoiser_stack.cu` with its `STAMP(i)` hooks defined
(`clock64()` and `%globaltimer` from thread 0 of every CTA) and runs the
20-layer C = 256 stack of one B = 1 request at frame bucket 1000 and of a
B = 4 request at bucket 512 (random weights, bf16), both as the kernel
runs (all layers in one launch where the card holds the grid) and as the
`per_layer` variant below, after half a second of warm-up.  It prints the
cycles a CTA spends in each phase of a layer, summed over the layers of
its launch and divided by them: the loads of condp and the wait (for the
launch before, or for the neighbour tiles' edge rows, after the layer
before's epilogue), the loads of x and the exchange of y across the
cluster, the conv, the gate, the exchange of g, the output projection, and
the epilogue; then the span of the (last) launch, when its CTAs started,
and how many CTAs each SM ran.  The stack's time (CUDA events) is printed
beside, for the kernel built without and with the stamps.

`variants` builds copies of the source patched by SPEC, `;`-separated:
`slots:N` (weight chunks in shared memory at once, `kSlots`), `chunk:N` (K
steps per chunk, `kChunkSteps`), `inflight:N` (wgmma groups in flight,
`kInFlight`), `per_layer` (one launch per layer at every length, the
scheme the kernel keeps for sequences too long for the card) and `no_pdl`
(those launches without programmatic dependent launch).  It times the same
two stacks through each, beside the source as it is (`as-built`), in two
rounds in turns; with each variant's ptxas registers and spills, the
clusters the card holds, and its error against the bf16 plain version.

Builds go to `mixgantts_tpu_torch/_build/bench/`.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mixgantts_tpu_torch.ops import cuda_build  # noqa: E402
from mixgantts_tpu_torch.ops import denoiser_stack as den  # noqa: E402

CSRC = os.path.join(REPO, "mixgantts_tpu_torch", "csrc")
OUT = os.path.join(cuda_build.BUILD_DIR, "bench")
SHAPES = [(1, 1000), (4, 512)]
L = 20
PHASES = ("condp loads and wait", "x loads, y exchange", "conv", "gate", "g exchange",
          "output projection", "epilogue")
# per CTA and first layer of its launch: 0..7 the cycles of each phase summed over the launch's layers,
# 8 and 9 %globaltimer at its start and end, 10 its SM, 11 the last clock
STAMPS = '''__device__ long long g_stamps[1 << 14][12];
#define STAMP(i)                                                                   \\
  if (threadIdx.x == 0) {                                                          \\
    long long* s_ = g_stamps[((l_begin * B + b0 + blockIdx.y) * gridDim.x + blockIdx.x) \\
                             & ((1 << 14) - 1)];                                   \\
    const long long now_ = clock64();                                             \\
    unsigned long long g_;                                                         \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                         \\
    if (i == 0) {                                                                  \\
      for (int k_ = 0; k_ < 8; ++k_) s_[k_] = 0;                                   \\
      unsigned sm_;                                                                \\
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                             \\
      s_[8] = (long long)g_;                                                       \\
      s_[10] = sm_;                                                                \\
    } else if (i < 8) {                                                            \\
      s_[i] += now_ - s_[11];                                                      \\
    } else {                                                                       \\
      s_[9] = (long long)g_;                                                       \\
    }                                                                              \\
    s_[11] = now_;                                                                 \\
  }
'''


def build(named_sources):
    """{name: source (a variant of denoiser_stack.cu)} -> {name: ctypes
    library}, one nvcc each beside copies of the shared headers, all started
    together; nvcc's report goes to nvcc.log beside each library."""
    jobs = {}
    for name, src in named_sources.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for header in (n for n in os.listdir(CSRC) if n.endswith(".cuh")):
            with open(os.path.join(CSRC, header)) as f, open(os.path.join(d, header), "w") as g:
                g.write(f.read())
        with open(os.path.join(d, "denoiser_stack.cu"), "w") as f:
            f.write(src)
        so = os.path.join(d, "libdenoiser_stack.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
               os.path.join(d, "denoiser_stack.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), d, so)
    libs = {}
    for name, (proc, d, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-4000:]}")
        with open(os.path.join(d, "nvcc.log"), "w") as f:
            f.write(out)
        libs[name] = ctypes.CDLL(so)
    return libs


def inputs(B, T, C=256, Hc=256, L=20, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)

    def t(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    stacked = {"conv_w": t(L, 3, C, 2 * C, scale=(3 * C) ** -0.5), "conv_b": t(L, 2 * C, scale=0.1),
               "cond_w": t(L, Hc, C, scale=Hc ** -0.5), "cond_b": t(L, C, scale=0.1),
               "step_w": t(L, C, C, scale=C ** -0.5), "out_w": t(L, C, 2 * C, scale=C ** -0.5),
               "out_b": t(L, 2 * C, scale=0.1)}
    return t(B, T, C), t(B, T, Hc), t(B, C), den.denoiser_kernel_weights(stacked)


def warm_up(fn, seconds=0.5):
    """Run fn until `seconds` have passed, so that the card's clocks have
    risen before anything is timed."""
    import time
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def time_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phases():
    with open(os.path.join(CSRC, "denoiser_stack.cu")) as f:
        stamped = f.read()
    stamped = stamped.replace('#include "mrf_mma.cuh"\n', '#include "mrf_mma.cuh"\n' + STAMPS, 1)
    stamped = stamped.replace(
        'extern "C" {\n', 'extern "C" {\nint denoiser_stack_stamps(long long* h, int n) { '
        'return (int)cudaMemcpyFromSymbol(h, g_stamps, (size_t)n * 96); }\n', 1)
    libs = build({"as-built": patched(""), "as-built-stamped": patched("", stamped),
                  "per_layer": patched("per_layer"),
                  "per_layer-stamped": patched("per_layer", stamped)})
    built = den._library()
    try:
        for B, T in SHAPES:
            x, cond, step, kw = inputs(B, T)
            def run():
                return den._launch(x, cond, step, kw)
            warm_up(run)
            for scheme in ("as-built", "per_layer"):
                cuda_build._loaded["denoiser_stack"] = libs[scheme]
                ms_built = time_ms(run)
                lib = cuda_build._loaded["denoiser_stack"] = libs[scheme + "-stamped"]
                ms_stamped = time_ms(run)
                launches = run()[2]
                torch.cuda.synchronize()
                n = den.launch_shape(B, T, 256)[0]
                h = np.zeros((L * n, 12), np.int64)
                if lib.denoiser_stack_stamps(h.ctypes.data_as(ctypes.c_void_p), L * n):
                    raise RuntimeError("reading the stamps failed")
                # all layers in the launches of layer 0, or the last layer's launch
                layers, h = (L, h[:n]) if launches < L else (1, h[-n:])
                per = h[:, 1:8].mean(axis=0) / layers
                t0 = h[:, 8].min()
                span = h[:, 9].max() - t0
                starts = np.sort(h[:, 8] - t0) / 1e3
                sms = np.bincount(np.unique(h[:, 10], return_counts=True)[1])
                print(f"B={B} T={T} [{scheme}], {launches} launch(es): stack {ms_built:.4f} ms "
                      f"as built, {ms_stamped:.4f} ms stamped ({1e3 * ms_built / L:.2f} us a "
                      f"layer); cycles per CTA and layer: "
                      + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(PHASES, per))
                      + f"; total {per.sum():.0f}; span of the last launch {span / 1e3:.2f} us; "
                      f"CTA start offsets (us) min/median/max {starts[0]:.2f}/"
                      f"{np.median(starts):.2f}/{starts[-1]:.2f}; SMs by CTAs run: "
                      f"{dict((k, int(v)) for k, v in enumerate(sms) if v)}", flush=True)
    finally:
        cuda_build._loaded["denoiser_stack"] = built


CONSTANTS = {"slots": "kSlots", "chunk": "kChunkSteps", "inflight": "kInFlight"}
SCHEMES = {"per_layer": ("if (tiles <= resident) {", "if (false) {"),
           "no_pdl": ("cfg.numAttrs = l > 0 ? 2 : 1;", "cfg.numAttrs = 1;")}


def patched(spec, src=None):
    """The kernel's source (or `src`, a copy of it) patched by SPEC."""
    if src is None:
        with open(os.path.join(CSRC, "denoiser_stack.cu")) as f:
            src = f.read()
    for part in filter(None, spec.split(";")):
        if part in SCHEMES:
            old, new = SCHEMES[part]
            n = src.count(old)
            src = src.replace(old, new)
        else:
            key, val = part.split(":")
            src, n = re.subn(r"constexpr int %s = \d+;" % CONSTANTS[key],
                             f"constexpr int {CONSTANTS[key]} = {int(val)};", src)
        if n != 1:
            raise ValueError(f"cannot apply {part!r}")
    return src


def variants(specs):
    built = den._library()
    libs = build({f"variant-{name}": patched(spec)
                  for name, spec in {"as-built": "", **specs}.items()})
    libs = {name[len("variant-"):]: lib for name, lib in libs.items()}
    cases = []
    for B, T in SHAPES:
        x, cond, step, kw = inputs(B, T)
        cases.append((B, T, x, cond, step, kw, den.fused_residual_stack_plain(x, cond, step, kw)))
    warm_up(lambda: den._launch(*cases[0][2:6]))
    try:
        for name, lib in libs.items():
            cuda_build._loaded["denoiser_stack"] = lib
            _, _, resident = den.launch_shape(1, 1000, 256)
            with open(os.path.join(OUT, f"variant-{name}", "nvcc.log")) as f:
                usage = [ln.split(":", 1)[-1].strip() for ln in f if "registers" in ln or "spill" in ln]
            print(f"[{name}] {specs.get(name, 'as the source is')}: {resident} clusters resident; "
                  f"ptxas {'; '.join(usage)}", flush=True)
        for rnd in range(2):
            for name, lib in (libs.items() if rnd == 0 else reversed(libs.items())):
                cuda_build._loaded["denoiser_stack"] = lib
                parts = []
                for B, T, x, cond, step, kw, want in cases:
                    got = den._launch(x, cond, step, kw)
                    err = max(((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(got[:2], want))
                    ms = time_ms(lambda: den._launch(x, cond, step, kw))
                    parts.append(f"B={B} T={T} {ms:.4f} ms in {got[2]} launch(es) "
                                 f"(err {err:.1e})")
                print(f"round {rnd} [{name}] " + "; ".join(parts), flush=True)
    finally:
        cuda_build._loaded["denoiser_stack"] = built


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_denoiser: needs a CUDA device")
    mode, *rest = sys.argv[1:] or ["phases"]
    torch.backends.cudnn.allow_tf32 = False
    if mode == "phases":
        phases()
    elif mode == "variants":
        variants(dict(a.split("=", 1) for a in rest))
    else:
        sys.exit(__doc__)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip())


if __name__ == "__main__":
    main()
