"""Device time by program span, read from a `trace.Profile`: each device op
of the profiled stretch goes to the program's spans (`span` in
`mixgantts_tpu_torch/utils/profiling.py`: dotted names such as
`model.encoder` or `train.backward`) that were open on the host when the
runtime call that launched it ran.

A `Profile` keeps the host's operations, the runtime calls among them
(`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...), and the
device's kernels, copies and sets, but not kineto's correlation ids that
link a device op to its call.  The program launches all its work on one
stream, where the device runs ops in the order they were launched, so the
n-th launch of a kind (kernel, copy, set) is the n-th device op of that
kind.  Where the counts of a kind disagree (an event the profiler lost),
the pairs are made within each stretch between two host synchronisations
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`), which drain the
stream: a launch before the sync's start runs before its end, an op is
placed by its midpoint against the sync's end, and a stretch's pairs stop
at its shorter list, so the fault stays inside one stretch; the ops left
over are counted in `unpaired` and belong to no span.  A launch belongs to
every span open at its start, on any thread: the program opens spans on
the main thread, and the launches autograd's device thread makes inside a
`.backward()` fall in the `train.backward` open meanwhile.
"""

import bisect

LAUNCHES = {"kernel": ("LaunchKernel", "LaunchCooperativeKernel"),
            "gpu_memcpy": ("Memcpy",), "gpu_memset": ("Memset",)}
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def launch_kind(name):
    """The device op kind a CUDA API call (`cuda*` or `cu*`) launches, else None."""
    if not name.startswith("cu"):
        return None
    return next((kind for kind, parts in LAUNCHES.items() if any(p in name for p in parts)),
                None)


def _stretch(times, edges):
    return [bisect.bisect_right(edges, t) for t in times]


class Attribution:
    """The launch time of every device op of a profile that could be
    paired: `pairs` [(host time of the launch, device op)], `unpaired`,
    the device ops left without one, and `spans`, each span name's merged
    host intervals."""

    def __init__(self, profile):
        launches = sorted((s, kind) for s, _, name, annotation in profile.host
                          if not annotation and (kind := launch_kind(name)) is not None)
        self.pairs, self.unpaired = [], 0
        for kind in LAUNCHES:
            times = [t for t, k in launches if k == kind]
            ops = [op for op in profile.device_ops if op[3] == kind]
            if len(times) == len(ops):
                self.pairs += zip(times, ops)
            else:
                self._pair_by_stretch(profile, times, ops)
        intervals = {}
        for s, e, name, annotation in profile.host:
            if annotation:
                intervals.setdefault(name, []).append((s, e))
        self.spans = {name: _merged(iv) for name, iv in intervals.items()}

    def _pair_by_stretch(self, profile, times, ops):
        syncs = sorted((s, e) for s, e, name, annotation in profile.host
                       if not annotation and name in SYNCS)
        launch_at = _stretch(times, [s for s, _ in syncs])
        op_at = _stretch([(op[0] + op[1]) / 2 for op in ops], [e for _, e in syncs])
        host, device = {}, {}
        for t, k in zip(times, launch_at):
            host.setdefault(k, []).append(t)
        for op, k in zip(ops, op_at):
            device.setdefault(k, []).append(op)
        for k, stretch_ops in device.items():
            stretch_times = host.get(k, [])
            self.pairs += zip(stretch_times, stretch_ops)
            self.unpaired += max(0, len(stretch_ops) - len(stretch_times))

    def open_at(self, name, t):
        """Whether a span `name` was open at host time t."""
        starts, ends = self.spans.get(name, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < ends[i]

    def device_s(self, names, exclude=()):
        """Device seconds of the ops launched inside any span of `names`
        and inside none of `exclude`."""
        return 1e-9 * sum(
            op[1] - op[0] for t, op in self.pairs
            if any(self.open_at(n, t) for n in names)
            and not any(self.open_at(n, t) for n in exclude))


def _merged(intervals):
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def span_device_s(profile, names, exclude=()):
    """Device seconds of a profile's ops launched inside any span of
    `names` and none of `exclude`; None where the profile holds no span of
    `names` (an untraced program, or one without these spans)."""
    if profile is None:
        return None
    attribution = Attribution(profile)
    if not any(n in attribution.spans for n in names):
        return None
    return attribution.device_s(names, exclude)


def per_call_ms(r, names, exclude=()):
    """Device ms of `names` (outside `exclude`) a profiled synthesis call;
    None outside a traced synthesis run or without the spans."""
    if r.data is None or r.data["kind"] != "synth" or not r.data["profiled"]:
        return None
    device_s = span_device_s(r.profile, names, exclude)
    return None if device_s is None else 1e3 * device_s / len(r.data["profiled"])


def per_step_ms(r, names, exclude=()):
    """Device ms of `names` (outside `exclude`) a profiled train step; None
    outside a traced training run or without the spans."""
    if r.data is None or r.data["kind"] != "train" or not r.data["steps_profiled"]:
        return None
    device_s = span_device_s(r.profile, names, exclude)
    return None if device_s is None else 1e3 * device_s / r.data["steps_profiled"]
