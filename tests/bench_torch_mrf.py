"""Where the MRF kernels' time goes, and what their configuration buys, on
one CUDA device (it needs the card and nvcc; no JAX).

    python3 tests/bench_torch_mrf.py variants NAME=SPEC [NAME=SPEC ...]
    python3 tests/bench_torch_mrf.py phases
    python3 tests/bench_torch_mrf.py streamed [NAME=SPEC ...]
    python3 tests/bench_torch_mrf.py narrow [NAME=SPEC ...]

`variants` builds copies of `csrc/mrf_stack.cu` whose `Cfg` table is
patched by SPEC and times the MRF calls of one B=1 request at frame bucket
1000 through each (CUDA events, mean of 10 calls, two rounds in turns),
beside the kernel as it is (`as-built`).  SPEC is `;`-separated
`C:WG,MT,KCH,S,NB,MIN_BLOCKS` entries (the fields of `Cfg<C>`), and
`batch:N` for the loads in flight per thread (`kBatch`); each variant's
ptxas registers and spills are printed, and its error against the bf16
plain version.

`phases` builds the kernel as it is with `clock64()` stamps at the phase
boundaries of each block (thread 0: the input tile's loads, conv1, conv1's
epilogue, conv2, conv2's epilogue) and prints the mean cycles of each phase
per block, for one k = 3 and one k = 11 pair launch (dilation 5) at each
width of the request, with the launch's span and the blocks resident at
once (sum of block times over span x SMs).

`streamed` does the same for the whole-stage kernel
(`csrc/mrf_stack_streamed.cu`) at V1's C=256 stage in a B=1 request at
bucket 1000 (T=8000) and a B=4 request at bucket 512 (T=4096): the cycles
thread 0 of each CTA spends per k=11 pass in each phase (the wait for the
other CTAs' conv2 with the branch start, the tile's build and all-gather,
conv1, the wait for the other CTAs' conv1, conv1's epilogue and its
all-gather, conv2, the epilogue), the launch's span and the CTAs busy per
SM, beside the time as built and stamped; then each NAME=SPEC variant (see
`streamed_source`) timed in two rounds in turns, with its ptxas report, its
plan, recompute share and error against the bf16 plain version.

`narrow` does the same for the narrow stages' kernel
(`csrc/mrf_stage_narrow.cu`) at the stages it runs in a B=1 HiFi-GAN V2
request at bucket 1000 (NARROW_STAGES: C = 16 and 8): each stage's time
as built and stamped, and the cycles thread 0 of
each block spends a pair in each phase (the wait between pairs, X's build,
conv1, its epilogue, conv2, its epilogue), the launch's span and the blocks
busy per SM; then each NAME=SPEC variant (see `narrow_source`) timed in
two rounds in turns, with its ptxas report, plan and error against the bf16
plain version.

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

from mixgantts_tpu_torch.ops import cuda_build, mrf  # noqa: E402

CSRC = os.path.join(REPO, "mixgantts_tpu_torch", "csrc")
OUT = os.path.join(cuda_build.BUILD_DIR, "bench")
REQUEST = [(256, 8000, (3,)), (256, 8000, (7,)), (256, 8000, (11,)),
           (128, 64000, (3, 7, 11)), (64, 128000, (3, 7, 11)), (32, 256000, (3, 7, 11))]


def patched(spec):
    src = open(os.path.join(CSRC, "mrf_stack.cu")).read()
    for part in filter(None, spec.split(";")):
        key, vals = part.split(":")
        if key == "batch":
            src, n = re.subn(r"constexpr int kBatch = \d+;", f"constexpr int kBatch = {vals};", src)
        else:
            wg, mt, kch, s, nb, mb = vals.split(",")
            src, n = re.subn(
                r"struct Cfg<%s> \{\n  static constexpr int [^;]*;" % key,
                f"struct Cfg<{key}> {{\n  static constexpr int kWG = {wg}, kMT = {mt}, "
                f"kKCH = {kch}, kS = {s}, kNB = {nb}, kMinBlocks = {mb};", src)
        if n != 1:
            raise ValueError(f"cannot apply {part!r}")
    return src


def build(named_sources, source="mrf_stack"):
    """{name: source text (a variant of csrc/<source>.cu)} -> {name: (ctypes
    library, ptxas report)}, one nvcc each beside copies of the shared
    headers, all started together."""
    jobs = {}
    for name, src in named_sources.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for header in (n for n in os.listdir(CSRC) if n.endswith(".cuh")):
            with open(os.path.join(CSRC, header)) as f, open(os.path.join(d, header), "w") as g:
                g.write(f.read())
        with open(os.path.join(d, source + ".cu"), "w") as f:
            f.write(src)
        so = os.path.join(d, f"lib{source}.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, os.path.join(d, source + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-4000:]}")
        report, kernel = [], None
        for line in out.splitlines():
            m = re.search(r"mrf_pair_mmaILi(\d+)ELi(\d+)E|mrf_stage_streamed|"
                          r"mrf_stage_narrowILi(\d+)E", line)
            if m and "entry function" in line:
                kernel = (f"<{m.group(1)}, {m.group(2)}>" if m.group(1) else
                          f"narrow<{m.group(3)}>" if m.group(3) else "streamed")
            elif kernel and ("Used" in line or "spill" in line):
                report.append(f"{kernel} {line.split(':', 1)[-1].strip()}")
            if "C7520" in line:   # ptxas serialized the wgmmas
                report.append("wgmma serialized (C7520)")
        libs[name] = (ctypes.CDLL(so), report)
    return libs


def weights(C, kernel_sizes):
    g = torch.Generator().manual_seed(C)
    w = torch.zeros(2, len(kernel_sizes), 3, mrf.TAPS, C, C)
    for i, k in enumerate(kernel_sizes):
        pad = (mrf.TAPS - k) // 2
        w[:, i, :, pad:pad + k] = torch.randn(2, 3, k, C, C, generator=g) * (k * C) ** -0.5
    b = torch.randn(2, len(kernel_sizes), 3, C, generator=g) * 0.1
    st = {"w1": w[0], "w2": w[1], "b1": b[0], "b2": b[1]}
    return mrf.kernel_weights({k: v.contiguous().cuda() for k, v in st.items()}, kernel_sizes)


def time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def variants(specs):
    libs = build({"as-built": patched(""), **{n: patched(s) for n, s in specs.items()}})
    for name, (_, report) in libs.items():
        spills = [r for r in report if "spill" in r and not r.endswith(" 0 bytes spill loads")]
        regs = sorted({r.split("Used ")[1].split(" registers")[0] for r in report if "Used" in r})
        print(f"[{name}] {specs.get(name, 'the Cfg table as built')}: registers {regs}; "
              f"{'spills: ' + '; '.join(spills) if spills else 'no spills'}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    calls = []
    for C, T, ks in REQUEST:
        st = weights(C, ks)
        x = torch.randn(1, T, C, device="cuda", generator=torch.Generator("cuda").manual_seed(T))
        calls.append((C, ks, st, x, mrf.mrf_stack_plain(x, st, ks)))
    for rnd in range(2):
        for name, (lib, _) in (libs.items() if rnd == 0 else reversed(libs.items())):
            cuda_build._loaded["mrf_stack"] = lib
            parts, total = [], 0.0
            for C, ks, st, x, want in calls:
                got = mrf.mrf_stack(x, st, ks)
                err = ((got - want).abs().max() / want.abs().max()).item()
                ms = time_ms(lambda: mrf.mrf_stack(x, st, ks))
                total += ms
                parts.append(f"C={C} k={ks} {ms:.4f} ms (err {err:.1e})")
            print(f"round {rnd} [{name}] {total:.4f} ms: " + "; ".join(parts), flush=True)
    cuda_build._loaded.pop("mrf_stack")


def phases():
    src = patched("")
    src = src.replace('#include "mrf_mma.cuh"\n', '''#include "mrf_mma.cuh"
__device__ long long g_stamps[1 << 17][8];
#define STAMP(i)                                                                        \\
  if (threadIdx.x == 0) {                                                               \\
    long long* s_ = g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) & ((1 << 17) - 1)];  \\
    s_[i] = clock64();                                                                  \\
    if (i == 0 || i == 5) {                                                             \\
      unsigned long long g_;                                                            \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                            \\
      s_[6 + (i == 5)] = (long long)g_;                                                 \\
    }                                                                                   \\
  }
''', 1)
    # (anchor, stamp): the stamp goes at the anchor's blank line, or after it
    marks = [("  const int tid = threadIdx.x;\n\n  // the input tile", 0),
             ("  consumer_sync<P::kConsumers>();\n\n  const int wg", 1),
             ("full, empty, 0, leader);\n", 2),
             ("  consumer_sync<P::kConsumers>();\n\n  // conv2", 3),
             ("full, empty, Q::kQ, leader);\n", 4)]
    for anchor, i in marks:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        head, blank, rest = anchor.partition("\n\n")
        stamped = f"{head}\n  STAMP({i})\n\n{rest}" if blank else f"{anchor}  STAMP({i})\n"
        src = src.replace(anchor, stamped)
    end = src.index("// One residual pair: out = [out +]")
    close = src.rindex("}\n", 0, end)
    src = src[:close] + "  STAMP(5)\n" + src[close:]
    src = src.replace('extern "C" {\n', 'extern "C" {\nint mrf_stack_stamps(long long* h, int n) '
                      '{ return (int)cudaMemcpyFromSymbol(h, g_stamps, (size_t)n * 64); }\n', 1)
    lib, _ = build({"phases": src})["phases"]
    cuda_build._loaded["mrf_stack"] = lib
    names = ("tile loads", "conv1", "conv1 epilogue", "conv2", "conv2 epilogue")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for C, T, _ in REQUEST[2:]:
        for k in (3, 11):
            st = weights(C, (k,))
            x = torch.randn(1, T, C, device="cuda")
            mrf.mrf_stack(x, st, (k,))      # three pair launches; the last (d = 5) stays
            torch.cuda.synchronize()
            n = -(-T // mrf.tile_frames(C, k))
            h = np.zeros((n, 8), np.int64)
            if lib.mrf_stack_stamps(h.ctypes.data_as(ctypes.c_void_p), n):
                raise RuntimeError("reading the stamps failed")
            per = np.diff(h[:, :6], axis=1).mean(axis=0)
            span = h[:, 7].max() - h[:, 6].min()
            resident = (h[:, 7] - h[:, 6]).sum() / span / n_sm
            print(f"C={C} T={T} k={k} d=5: {n} blocks; cycles per block: " +
                  ", ".join(f"{nm} {c:.0f}" for nm, c in zip(names, per)) +
                  f"; total {per.sum():.0f}; launch span {span / 1e3:.1f} us; "
                  f"blocks resident per SM {resident:.2f}", flush=True)
    cuda_build._loaded.pop("mrf_stack")


STAGE = [(1, 8000), (4, 4096)]   # V1's C=256 stage in a B=1 request at bucket 1000, B=4 at 512
STREAMED_PHASES = ("branch start and wait for the peers' conv2", "A build and all-gather",
                   "conv1", "wait for the peers' conv1", "h epilogue and all-gather", "conv2",
                   "epilogue")
# per CTA: 0..6 the cycles of each phase summed over its k = 11 passes, 7 those passes, 8 and
# 9 %globaltimer at its start and at its last pass's end, 10 the last clock
STREAMED_STAMPS = """__device__ long long g_stamps[1 << 13][11];
#define STAMP(i)                                                                    \\
  if (threadIdx.x == 0) {                                                           \\
    long long* s_ = g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) & ((1 << 13) - 1)]; \\
    const long long now_ = clock64();                                              \\
    unsigned long long g_;                                                          \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                          \\
    if (i == 0 && pass == 0) {                                                      \\
      for (int z_ = 0; z_ < 8; ++z_) s_[z_] = 0;                                    \\
      s_[8] = (long long)g_;                                                        \\
    } else if (k == 11) {                                                           \\
      s_[i == 0 ? 0 : i - 1] += now_ - s_[10];                                      \\
    }                                                                               \\
    if (i == 7) {                                                                   \\
      s_[7] += k == 11;                                                             \\
      s_[9] = (long long)g_;                                                        \\
    }                                                                               \\
    s_[10] = now_;                                                                  \\
  }
"""
STREAMED_PATCHES = {"batch": r"\bkBatch = \d+", "groups": r"\bkGroups = \d+", "wg": r"\bkWG = \d+", "mt": r"\bkMT = \d+", "kch": r"\bkKCH = \d+",
                    "s": r"\bkS = \d+", "fly": r"\bkFly = \d+"}
PER_ROW = "const int per_row = resident / B > 1 ? resident / B : 1;"


def streamed_source(spec="", stamps=False):
    """csrc/mrf_stack_streamed.cu patched by SPEC (`;`-separated): `wg:N`,
    `mt:N` (consumer warpgroups and their 64-row tiles: rows per pass),
    `kch:N`, `s:N` (the ring's K rows per stage and stages), `fly:N` (wgmma
    groups in flight), `groups:N` (column groups per epilogue batch), `batch:N` (rows of y per
    load batch building a tile),
    `tiles:N` (N times the clusters of one wave, smaller tiles); with the
    STAMP hooks defined where `stamps` is set."""
    with open(os.path.join(CSRC, "mrf_stack_streamed.cu")) as f:
        src = f.read()
    for part in filter(None, spec.split(";")):
        key, _, val = part.partition(":")
        if key == "tiles":
            n = src.count(PER_ROW)
            src = src.replace(PER_ROW, f"const int per_row = {int(val)} * "
                                       "(resident / B > 1 ? resident / B : 1);")
        else:
            pattern = STREAMED_PATCHES[key]
            src, n = re.subn(pattern, pattern.replace(r"\d+", val).replace(r"\b", ""), src)
        if n != 1:
            raise ValueError(f"cannot apply {part!r}")
    if stamps:
        src = src.replace('#include "mrf_mma.cuh"\n', '#include "mrf_mma.cuh"\n' + STREAMED_STAMPS, 1)
        src = src.replace('extern "C" {\n', 'extern "C" {\nint mrf_stack_streamed_stamps(long long* h, '
                          'int n) { return (int)cudaMemcpyFromSymbol(h, g_stamps, (size_t)n * 88); }\n',
                          1)
    return src


def stage_cases():
    st = weights(256, (3, 7, 11))
    cases = []
    for B, T in STAGE:
        x = torch.randn(B, T, 256, device="cuda", generator=torch.Generator("cuda").manual_seed(T))
        cases.append((B, T, x, mrf.mrf_stack_plain(x, st)))
    return st, cases


def streamed_phases():
    libs = build({"streamed": streamed_source(), "streamed-stamped": streamed_source(stamps=True)},
                 "mrf_stack_streamed")
    st, cases = stage_cases()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for B, T, x, _ in cases:
            cuda_build._loaded["mrf_stack_streamed"] = libs["streamed"][0]
            ms = time_ms(lambda: mrf.mrf_stack_streamed(x, st))
            lib = cuda_build._loaded["mrf_stack_streamed"] = libs["streamed-stamped"][0]
            ms_stamped = time_ms(lambda: mrf.mrf_stack_streamed(x, st))
            plan = mrf.streamed_plan(B, T)
            n = B * plan["cluster"] * -(-T // plan["tile"])
            h = np.zeros((n, 11), np.int64)
            if lib.mrf_stack_streamed_stamps(h.ctypes.data_as(ctypes.c_void_p), n):
                raise RuntimeError("reading the stamps failed")
            per = h[:, :7].sum(axis=0) / h[:, 7].sum()
            span = h[:, 9].max() - h[:, 8].min()
            busy = (h[:, 9] - h[:, 8]).sum() / span / n_sm
            print(f"B={B} T={T} (tile {plan['tile']}, {n} CTAs): {ms:.4f} ms as built, "
                  f"{ms_stamped:.4f} ms stamped; cycles per CTA and k=11 pass "
                  f"({h[:, 7].mean():.2f} passes a CTA): "
                  + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(STREAMED_PHASES, per))
                  + f"; total {per.sum():.0f}; launch span {span / 1e3:.1f} us, CTAs busy per "
                  f"SM {busy:.2f}", flush=True)
    finally:
        cuda_build._loaded.pop("mrf_stack_streamed", None)


def streamed_variants(specs):
    libs = build({name: streamed_source(spec) for name, spec in {"as-built": "", **specs}.items()},
                 "mrf_stack_streamed")
    for name, (_, report) in libs.items():
        print(f"[{name}] {specs.get(name, 'as the source is')}: {'; '.join(report)}", flush=True)
    st, cases = stage_cases()
    try:
        for rnd in range(2):
            for name, (lib, _) in (libs.items() if rnd == 0 else reversed(libs.items())):
                cuda_build._loaded["mrf_stack_streamed"] = lib
                parts = []
                for B, T, x, want in cases:
                    got = mrf.mrf_stack_streamed(x, st)
                    err = ((got - want).abs().max() / want.abs().max()).item()
                    ms = time_ms(lambda: mrf.mrf_stack_streamed(x, st))
                    plan = mrf.streamed_plan(B, T)
                    share = mrf.streamed_flops(B, T) / (2 * 3 * 2 * 21 * 256 * 256 * B * T)
                    parts.append(f"B={B} T={T} {ms:.4f} ms (tile {plan['tile']}, clusters of "
                                 f"{plan['cluster']}, {plan['resident']} resident, recompute "
                                 f"{share:.3f}, "
                                 f"err {err:.1e})")
                print(f"round {rnd} [{name}] " + "; ".join(parts), flush=True)
    finally:
        cuda_build._loaded.pop("mrf_stack_streamed", None)


# the stages of a B=1 HiFi-GAN V2 request at bucket 1000 the kernel runs, (C, T)
NARROW_STAGES = [(16, 128000), (8, 256000)]
NARROW_PHASES = ("between pairs", "X build", "conv1", "conv1 epilogue", "conv2",
                 "conv2 epilogue")
# per block: 0..5 the cycles of each phase summed over its pairs, 6 the last
# clock, 7 and 8 %globaltimer at its start and end, 9 its pairs
NARROW_STAMPS = """__device__ long long g_stamps[1 << 14][10];
#define STAMP(i)                                                                    \\
  if (threadIdx.x == 0) {                                                           \\
    long long* s_ = g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) & ((1 << 14) - 1)]; \\
    const long long now_ = clock64();                                              \\
    unsigned long long g_;                                                          \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                          \\
    if ((i) == 6) {                                                                 \\
      for (int z_ = 0; z_ < 6; ++z_) s_[z_] = 0;                                    \\
      s_[7] = (long long)g_;                                                        \\
      s_[9] = 0;                                                                    \\
    } else if ((i) == 7) {                                                          \\
      s_[8] = (long long)g_;                                                        \\
    } else {                                                                        \\
      s_[i] += now_ - s_[6];                                                        \\
      s_[9] += (i) == 5;                                                            \\
    }                                                                               \\
    s_[6] = now_;                                                                   \\
  }
"""
NARROW_PATCHES = {"c16": "Cfg<16>", "c8": "Cfg<8>"}


def narrow_source(spec="", stamps=False):
    """csrc/mrf_stage_narrow.cu patched by SPEC (`;`-separated):
    `c16:WG,MT,KCH,S,NB,BLOCKS` and `c8:...` (the fields of `Cfg<16>` and
    `Cfg<8>`: consumer warpgroups, their 64-row tiles, K rows per ring
    stage, stages, fragment buffers, blocks an SM); with the STAMP hooks
    defined where `stamps` is set."""
    with open(os.path.join(CSRC, "mrf_stage_narrow.cu")) as f:
        src = f.read()
    for part in filter(None, spec.split(";")):
        key, _, val = part.partition(":")
        cfg = NARROW_PATCHES[key]
        names = ("kWG", "kMT", "kKCH", "kS", "kNB", "kBlocks")
        fields = ", ".join(f"{n} = {v}" for n, v in zip(names, val.split(",")))
        src, n = re.subn(r"struct %s \{\n  static constexpr int [^;]*;" % re.escape(cfg),
                         f"struct {cfg} {{\n  static constexpr int {fields};", src)
        if n != 1:
            raise ValueError(f"cannot apply {part!r}")
    if stamps:
        src = src.replace('#include "mrf_mma.cuh"\n', '#include "mrf_mma.cuh"\n' + NARROW_STAMPS, 1)
        src = src.replace('extern "C" {\n', 'extern "C" {\nint mrf_stage_narrow_stamps(long long* h, '
                          'int n) { return (int)cudaMemcpyFromSymbol(h, g_stamps, (size_t)n * 80); }\n',
                          1)
    return src


def narrow(specs):
    libs = build({"as-built": narrow_source(), "stamped": narrow_source(stamps=True),
                  **{name: narrow_source(spec) for name, spec in specs.items()}},
                 "mrf_stage_narrow")
    for name, (_, report) in libs.items():
        print(f"[{name}] {specs.get(name, 'as the source is')}: {'; '.join(report)}", flush=True)
    ks = (3, 7, 11)
    cases = []
    for C, T in NARROW_STAGES:
        st = weights(C, ks)
        x = torch.randn(1, T, C, device="cuda", generator=torch.Generator("cuda").manual_seed(T))
        cases.append((C, T, st, x, mrf.mrf_stack_plain(x, st, ks)))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        for C, T, st, x, _ in cases:
            cuda_build._loaded["mrf_stage_narrow"] = libs["as-built"][0]
            ms = time_ms(lambda: mrf.mrf_stack(x, st, ks))
            lib = cuda_build._loaded["mrf_stage_narrow"] = libs["stamped"][0]
            ms_stamped = time_ms(lambda: mrf.mrf_stack(x, st, ks))
            plan = mrf.narrow_plan(1, T, C=C)
            n = plan["blocks"]
            h = np.zeros((n, 10), np.int64)
            if lib.mrf_stage_narrow_stamps(h.ctypes.data_as(ctypes.c_void_p), n):
                raise RuntimeError("reading the stamps failed")
            per = h[:, :6].sum(axis=0) / h[:, 9].sum()
            span = h[:, 8].max() - h[:, 7].min()
            busy = (h[:, 8] - h[:, 7]).sum() / span / n_sm
            share = mrf.narrow_flops(1, T, C=C) / (2 * 3 * 2 * 21 * C * C * T)
            print(f"C={C} T={T} (tile {plan['tile']}, {n} blocks, {plan['resident']} resident, "
                  f"{plan['smem']} B, executed/needed FLOPs {share:.3f}): {ms:.4f} ms as built, "
                  f"{ms_stamped:.4f} ms stamped; cycles per block and pair: "
                  + ", ".join(f"{nm} {c:.0f}" for nm, c in zip(NARROW_PHASES, per))
                  + f"; total {per.sum():.0f}; launch span {span / 1e3:.1f} us, blocks busy per "
                  f"SM {busy:.2f}", flush=True)
        for rnd in range(2):
            names = [n for n in libs if n != "stamped"]
            for name in (names if rnd == 0 else reversed(names)):
                cuda_build._loaded["mrf_stage_narrow"] = libs[name][0]
                parts = []
                for C, T, st, x, want in cases:
                    got = mrf.mrf_stack(x, st, ks)
                    err = ((got - want).abs().max() / want.abs().max()).item()
                    ms = time_ms(lambda: mrf.mrf_stack(x, st, ks))
                    tile = mrf.narrow_plan(1, T, C=C)["tile"]
                    parts.append(f"C={C} T={T} {ms:.4f} ms (tile {tile}, err {err:.1e})")
                print(f"round {rnd} [{name}] " + "; ".join(parts), flush=True)
    finally:
        cuda_build._loaded.pop("mrf_stage_narrow", None)


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_torch_mrf: needs a CUDA device")
    mode, *rest = sys.argv[1:] or ["phases"]
    torch.backends.cudnn.allow_tf32 = False
    if mode == "variants":
        variants(dict(a.split("=", 1) for a in rest))
    elif mode == "phases":
        phases()
    elif mode == "streamed":
        streamed_phases()
        if rest:
            streamed_variants(dict(a.split("=", 1) for a in rest))
    elif mode == "narrow":
        narrow(dict(a.split("=", 1) for a in rest))
    else:
        sys.exit(__doc__)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(out.stdout.strip())


if __name__ == "__main__":
    main()
