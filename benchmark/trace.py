"""The traced part of a `--trace 1` run: `torch.profiler` over a short
steady stretch of the window, reduced to what the per-layer readers and
the result's `breakdown` take.

The stretch starts and ends on a synchronised device inside a span named
`profiled`; the device's busy time is the union of its kernels', copies'
and sets' intervals inside that span (kineto's `kernel`, `gpu_memcpy` and
`gpu_memset` activities; the spans' own device-side copies are not
work), and an idle gap is named by the spans and the innermost host
operation that were open at its middle.
"""

import contextlib

import torch

WINDOW = "profiled"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")   # kineto activity types
SPANS = (WINDOW, "submit", "collect", "acoustic", "vocoder", "stack", "chunk", "read")


def kind_of(e):
    """An event's kineto activity type, worked out from its device, its
    annotation flag and its name where the event does not say it."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if e.is_user_annotation() else "cpu_op"
    if e.is_user_annotation() or e.name() in SPANS:
        return "gpu_user_annotation"
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def start(device):
    torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    span = torch.autograd.profiler.record_function(WINDOW)
    span.__enter__()
    return prof, span, device


def stop(handle):
    prof, span, device = handle
    torch.cuda.synchronize(device)
    span.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    return Profile(prof)


class Profile:
    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        self.window = next((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                           if e.name() == WINDOW and e.device_type() == torch.autograd.DeviceType.CPU)
        lo, hi = self.window
        self.device_ops, self.host = [], []
        for e in events:
            s, d, kind = e.start_ns(), e.duration_ns(), kind_of(e)
            if kind in DEVICE_OPS:
                if s + d > lo and s < hi:
                    self.device_ops.append((max(s, lo), min(s + d, hi), e.name(), kind))
            elif e.device_type() == torch.autograd.DeviceType.CPU and s < hi and s + d > lo \
                    and e.name() != WINDOW:
                self.host.append((s, s + d, e.name(), e.is_user_annotation()))
        self.device_ops.sort()

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self):
        return [op for op in self.device_ops if op[3] == "kernel"]

    def kernel_s(self, patterns):
        """Device seconds of the kernels whose name holds one of `patterns`."""
        return 1e-9 * sum(e - s for s, e, n, _ in self.kernels() if any(p in n for p in patterns))

    def busy_intervals(self):
        merged = []
        for s, e, _, _ in self.device_ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return 1e-9 * sum(e - s for s, e in self.busy_intervals())

    def gaps(self):
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def host_at(self, t):
        """What the host was doing at time t: the open spans, outermost
        first, and the innermost operation."""
        open_ = [h for h in self.host if h[0] <= t < h[1]]
        spans = [h[2] for h in sorted(open_, key=lambda h: h[0]) if h[3]]
        ops = [h for h in open_ if not h[3]]
        inner = max(ops, key=lambda h: h[0])[2] if ops else "no host operation"
        return "/".join(spans + [inner])

    def breakdown(self, n=10):
        by_name = {}
        for s, e, name, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:160], v * 1e-9] for name, v in top],
                "idle_gaps": [[self.host_at((s + e) // 2)[:160], (e - s) * 1e-9]
                              for s, e in gaps]}


@contextlib.contextmanager
def span(name, on):
    """A profiler span around a harness step, only in a traced run."""
    if not on:
        yield
        return
    with torch.autograd.profiler.record_function(name):
        yield
