"""The shallow GAN training step (D phase, then G phase, each with Adam)
through `chunk_train_step(make_train_step("shallow", ...))`, as the train
CLI's segments run it: `steps_per_call` batches stacked on the host,
pinned and moved by the CLI's `to_device`, one chunk call, and its losses
read back with one copy.

End to end (host clock): `train_frames_per_s`, the unpadded mel frames of
every batch trained in the window over the time from the window's start
to the synchronised end of its last chunk.

Set-up builds one train state from the seed and drives its first three
steps through the same call and feed (one step, then two), on batches
whose rows all differ, keeping what the checks read: the losses, the
first gradient from Adam's first moment and the parameters after step 3.
The reference follows those three steps from the same weights, batches,
dropout seed and diffusion generator once the window has closed.
"""

import time

import numpy as np
import torch

from .. import core, traffic as T
from ..checks import LOSSES, judge_train, norms
from ..reference.arith import FULL
from ..reference.train_step import TrainStep


def run_chunk(state, chunk_fn, batches, device, span):
    """One segment as the train CLI runs it: stack, pin and move, the
    chunk call, one read back.  Returns {loss: [k values]}."""
    from mixgantts_tpu_torch.cli.common import model_batch_of, to_device
    with span("stack"):
        stacked = {key: np.stack([b[key] for b in batches]) for key in model_batch_of(batches[0])}
        on_device = to_device(stacked, device)
    with span("chunk"):
        metrics = chunk_fn(state, on_device)
    with span("read"):
        keys = list(metrics)
        values = torch.stack([metrics[k] for k in keys]).cpu().numpy()
    return {k: values[i] for i, k in enumerate(keys)}


def snapshot_grads(opt, module):
    """{leaf: norm of the gradient Adam took in} after its first update:
    mu = (1 - b1) g."""
    names = [n for n, _ in module.named_parameters()]
    if opt.mu is None:   # no update was applied
        return {n: 0.0 for n in names}
    return norms({n: m / (1.0 - opt.b1) for n, m in zip(names, opt.mu)})


def program_run(ctx, pool, seeds, span=None):
    """Build the program's train state, drive steps 1-3 (one, then two)
    and return (state, chunk_fn, weights, readings of the three steps)."""
    span = span or ctx.span
    cfg, spec, device = ctx.config, ctx.traffic, ctx.device
    state, chunk_fn, weights = core.program_train(cfg, device, seeds["weights"],
                                                  seeds["generator"], spec["restore_step"])
    core.log(f"set-up {ctx.clock():.2f} s: the program built, the weights loaded")
    torch.manual_seed(seeds["dropout"])
    m1 = run_chunk(state, chunk_fn, pool[:1], device, span)
    grads = {"G": snapshot_grads(state.opt_g, state.model),
             "D": snapshot_grads(state.opt_d, state.discriminator)}
    m23 = run_chunk(state, chunk_fn, pool[1:3], device, span)
    change = {}
    for key, module in (("G", state.model), ("D", state.discriminator)):
        change[key] = norms({n: p.detach() - weights[key][n]
                             for n, p in module.named_parameters()})
    losses = [{k: float(m[k][j]) for k in LOSSES} for m, j in ((m1, 0), (m23, 0), (m23, 1))]
    return state, chunk_fn, weights, {"losses": losses, "grads": grads, "change": change}


def reference_run(config, weights, batches, seeds, device, arith=FULL, count_flops=False):
    """The reference's first three steps from the same weights, batches,
    dropout seed and generator seed: its readings, and with `count_flops`
    the FLOP of its first step."""
    from ..work.counts import counted_flops
    rc = core.ref_config(config)
    ref = TrainStep(rc, config["stats"], device,
                    torch.Generator(device).manual_seed(seeds["generator"]))
    ref.G.load_state_dict(weights["G"], strict=True)
    ref.D.load_state_dict(weights["D"], strict=True)
    start = {"G": {n: p.detach().clone() for n, p in ref.G.named_parameters()},
             "D": {n: p.detach().clone() for n, p in ref.D.named_parameters()}}
    on = [{k: torch.as_tensor(v, device=device) for k, v in b.items()} for b in batches]
    torch.manual_seed(seeds["dropout"])
    losses, flops = [], None
    with arith.context():
        for i, batch in enumerate(on):
            if i == 0 and count_flops:
                box = {}
                flops = counted_flops(lambda: box.update(out=ref(batch)))
                losses.append(box["out"])
            else:
                losses.append(ref(batch))
            if i == 0:
                grads = {"G": norms(dict(zip([n for n, _ in ref.G.named_parameters()],
                                             ref.opt_g.last_grads))),
                         "D": norms(dict(zip([n for n, _ in ref.D.named_parameters()],
                                             ref.opt_d.last_grads)))}
    change = {key: norms({n: p.detach() - start[key][n] for n, p in module.named_parameters()})
              for key, module in (("G", ref.G), ("D", ref.D))}
    return {"losses": losses, "grads": grads, "change": change}, flops


def seeds_of(seed):
    return {"weights": core.sub_seed(seed, "w"), "generator": core.sub_seed(seed, "g"),
            "dropout": core.sub_seed(seed, "dropout")}


def run(ctx):
    cfg, spec, device = ctx.config, ctx.traffic, ctx.device
    k = spec["steps_per_call"]
    pool = T.train_pool(spec, ctx.seed, cfg)
    core.log(f"set-up {ctx.clock():.2f} s: the batches made")
    seeds = seeds_of(ctx.seed)
    state, chunk_fn, weights, program = program_run(ctx, pool, seeds)
    setup_s = ctx.begin_window()
    core.log(f"set-up {setup_s:.2f} s: steps 1-3 taken")

    frames, steps, chunk_times = 0, 0, []
    profiler, profiled = None, None
    start = time.perf_counter()
    c = 0
    while True:
        batches = [pool[(3 + c * k + j) % len(pool)] for j in range(k)]
        if ctx.trace and profiled is None and (
                time.perf_counter() - start >= spec["profile_after"] * ctx.seconds):
            profiler = ctx.start_profiler()
        t0 = time.perf_counter()
        run_chunk(state, chunk_fn, batches, device, ctx.span)
        t1 = time.perf_counter()
        if profiler is not None:
            ctx.stop_profiler(profiler)
            profiler, profiled = None, c
        else:
            chunk_times.append(t1 - t0)
        frames += sum(int(b["mel_lens"].sum()) for b in batches)
        steps += k
        c += 1
        if t1 - start >= ctx.seconds and (not ctx.trace or profiled is not None):
            break
    window = time.perf_counter() - start
    e2e = {"setup_s": setup_s, "train_frames_per_s": frames / window}
    device_info = ctx.read_device()
    finite = all(np.isfinite(v) for s in program["losses"] for v in s.values())

    del state, chunk_fn
    ctx.free()
    ref, flops = reference_run(cfg, weights, pool[:3], seeds, device, count_flops=ctx.trace)
    if ctx.stand_in is not None:   # calibration: the reference put in the program's place
        program = ctx.stand_in(cfg, weights, pool[:3], seeds, device)
    checks = judge_train(program, ref)
    readings = None
    if ctx.trace:
        readings = {"kind": "train", "steps_profiled": k, "step_flops": flops,
                    "step_s": [t / k for t in chunk_times]}
    return {"e2e": e2e, "readings": readings, "checks": checks, "device": device_info,
            "attempted": steps, "failed": 0 if finite else steps}
