"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.run --workload <cell> --self-test

The cell is found by name in BENCHMARK.json; its configuration, traffic,
driver (`drivers/<traffic's driver>.py`), limits (`limits/<cell>.json`) and
per-layer readers (`metrics/<metric>.py`) by the names there.  The last
line of standard output is the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`,
each compared number beside its limit (also the last lines of standard
error).

Without a CUDA device holding the cell's chips it exits 2 and prints no
result.  `--self-test` runs the cell's driver on the CPU at tiny widths
(plumbing only) and prints no result either.  Build caches stay inside the
checkout: the port's kernels in `mixgantts_tpu_torch/_build/`, Triton's
and torch's extensions in `.bench_cache/`.
"""

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

_T_IMPORT = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _sub)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import torch  # noqa: E402

from benchmark import core, trace  # noqa: E402
from benchmark.checks import verdict  # noqa: E402
from benchmark.reference.arith import FULL  # noqa: E402

THREADS = 2   # the host's intra-op threads: load from one process with few threads


def process_age_s():
    """Seconds since this process started (its start time in
    /proc/self/stat against CLOCK_BOOTTIME), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_of(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


class Readings:
    """What a per-layer reader reads: the driver's readings, the profile
    and the numbers of the result."""

    def __init__(self, data, profile):
        self.data, self.profile = data, profile


def cell_metrics(bench, cell_name, section):
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def make_context(args, cell, config, traffic, device):
    """What a driver is given: the cell, its configuration, traffic and
    limits, the run's arguments, and the harness's clock, spans, profiler
    and device readings."""
    ctx = SimpleNamespace(cell=cell, config=config, traffic=traffic, device=device,
                          limits=core.limits_of(cell["name"]), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace))
    # the program is judged; calibration puts the control in its place, as the
    # reference's arithmetic (synthesis) or a stand-in for its readings (training)
    ctx.arith, ctx.stand_in = FULL, None
    ctx.profile = None
    ctx.clock = process_age_s
    ctx.span = lambda name: trace.span(name, ctx.trace)

    def start_profiler():
        return trace.start(device)

    def stop_profiler(handle):
        ctx.profile = trace.stop(handle)

    def read_device():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return core.device_info(device, cell["chips"])

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def begin_window():
        """Set-up ends: what it left is collected and frozen out of the
        collector's later passes; returns the set-up's seconds."""
        gc.collect()
        gc.freeze()
        return process_age_s()

    ctx.start_profiler, ctx.stop_profiler = start_profiler, stop_profiler
    ctx.read_device, ctx.free, ctx.begin_window = read_device, free, begin_window
    return ctx


def self_test(args, cell, config, traffic):
    """The cell's driver on the CPU at tiny widths: plumbing only."""
    config, traffic = core.tiny(config, traffic)
    args.seconds = min(args.seconds, 2)
    ctx = make_context(args, cell, config, traffic, torch.device("cpu"))
    out = driver_of(traffic).run(ctx)
    correct, rows = verdict(out["checks"], ctx.limits)
    core.log(f"self-test {cell['name']}: {out['attempted']} attempted, "
             f"{out['failed']} failed, " + ", ".join(f"{k} {v:.4g}" for k, v in out["e2e"].items()))
    for name, value, limit in rows:
        core.log(f"self-test check {name} {value:.6g} limit {limit:.6g}")
    return out, correct


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--self-test", action="store_true")
    args = p.parse_args(argv)
    cell, config, traffic, bench = core.find_cell(args.workload)
    core.log(f"set-up {process_age_s():.2f} s: torch imported")
    if args.self_test:
        self_test(args, cell, config, traffic)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        core.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(THREADS)
    torch.backends.cudnn.allow_tf32 = False   # the configurations' float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros(1, device=device)
    core.log(f"set-up {process_age_s():.2f} s: the card reached")
    ctx = make_context(args, cell, config, traffic, device)
    out = driver_of(traffic).run(ctx)

    found = core.forbidden_modules()
    if found:
        core.log(f"modules of JAX or of the JAX package were loaded: {', '.join(found)}")
        return 3
    correct, rows = verdict(out["checks"], ctx.limits)
    correct = correct and out["failed"] == 0
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if args.trace:
        readings = Readings(out["readings"], ctx.profile)
        metrics = {}
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            reader = load_module(os.path.join(core.HERE, "metrics", m["name"] + ".py"),
                                 "metric_" + m["name"].replace(".", "_"))
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info = dict(out["device"], busy_s=ctx.profile.busy_s,
                           window_s=ctx.profile.window_s)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(bench, cell["name"], "end_to_end")}
        device_info = out["device"]
    result.update(metrics=metrics, device=device_info)
    if args.trace:
        result["breakdown"] = ctx.profile.breakdown()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        core.log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
