"""The traced run's readings: the prover's step spans and the device trace.

Spans: distaff_torch logs each step's wall time at DEBUG level ("step 0
execute program: <ms> ms" from execute(), "step <i> <name>: <ms> ms" from
the prover, which then synchronizes the device at each step's end).  The
handler here files each line under the request in flight and, while the
profiler runs, marks the step's span in the profiler's timeline (a
record_function range a step), so that idle time on the device can be put
down to what the host was doing.

Device trace: torch.profiler over the window.  Every kernel, copy and set
of memory on the card is an interval; their union is the busy time, its
complement within the window the idle time.
"""

import bisect
import logging
import re

STEP_LINE = re.compile(r"^step (\d+) (?!part )(.+): ([0-9.]+) ms$")
LOGGERS = ("distaff_torch",)
LAST_STEP = 9
SPAN = re.compile(r"^(step \d+|serialize)$")


class StepSpans(logging.Handler):
    """Files the step lines under the request in flight, and opens a
    profiler range for each step as the last one's line arrives."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.names = {}
        self._request = None
        self._range = None

    def install(self):
        for name in LOGGERS:
            logger = logging.getLogger(name)
            logger.setLevel(logging.DEBUG)
            logger.addHandler(self)
            logger.propagate = False

    def remove(self):
        for name in LOGGERS:
            logging.getLogger(name).removeHandler(self)

    def begin(self, request):
        self._request = request
        self._open("step 0")

    def end(self, request):
        self._close()
        self._request = None

    def emit(self, record):
        match = STEP_LINE.match(record.getMessage())
        if not match or self._request is None:
            return
        step, name, ms = int(match.group(1)), match.group(2), float(match.group(3))
        self._request.steps[step] = ms
        self.names[step] = f"step {step} {name}"
        self._open(f"step {step + 1}" if step < LAST_STEP else "serialize")

    def _open(self, name):
        from torch.profiler import record_function

        self._close()
        self._range = record_function(name)
        self._range.__enter__()

    def _close(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


class DeviceTrace:
    """torch.profiler over the window, and what its trace says."""

    def __init__(self, on_card):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self._profile = profile(activities=activities)
        self.kernels = []      # (name, start ns, end ns) of each device operation
        self.ranges = []       # (name, start ns, end ns) of each step span
        self.window = None     # (start ns, end ns)

    def __enter__(self):
        self._profile.start()
        return self

    def __exit__(self, *exc):
        self._profile.stop()
        self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType

        for event in self._profile.profiler.kineto_results.events():
            start = event.start_ns()
            end = start + event.duration_ns()
            if SPAN.match(event.name()):
                if event.device_type() != DeviceType.CUDA:
                    self.ranges.append((event.name(), start, end))
            elif event.device_type() == DeviceType.CUDA and not event.is_user_annotation():
                self.kernels.append((event.name(), start, end))
        if self.ranges:
            self.window = (min(r[1] for r in self.ranges), max(r[2] for r in self.ranges))

    def busy_intervals(self):
        """The union of the device's operations within the window, sorted."""
        if self.window is None:
            return []
        lo, hi = self.window
        merged = []
        for _, start, end in sorted(self.kernels, key=lambda k: k[1]):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9 if self.window else 0.0

    def busy_s(self):
        return sum(end - start for start, end in self.busy_intervals()) / 1e9

    def device_seconds(self, contains):
        """Summed device time of the operations whose name contains `contains`."""
        return sum(end - start for name, start, end in self.kernels if contains in name) / 1e9

    def top_operations(self, count=10):
        """The device operations that took the most time, summed by name."""
        totals = {}
        for name, start, end in self.kernels:
            totals[name] = totals.get(name, 0) + end - start
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
        return [[name, total / 1e9] for name, total in ranked]

    def idle_by_step(self, names, count=10):
        """The device's idle time in the window, summed by the span (a step
        of a request, the serialization, or the time between requests) that
        the host was in, the largest first."""
        if self.window is None:
            return []
        edges = [self.window[0]]
        for start, end in self.busy_intervals():
            edges += [start, end]
        edges.append(self.window[1])
        ranges = sorted(self.ranges, key=lambda r: r[1])
        starts = [r[1] for r in ranges]
        totals = {}
        for gap_start, gap_end in zip(edges[0::2], edges[1::2]):
            if gap_end <= gap_start:
                continue
            covered = 0
            i = max(0, bisect.bisect_right(starts, gap_start) - 1)
            while i < len(ranges) and ranges[i][1] < gap_end:
                name, start, end = ranges[i]
                overlap = min(end, gap_end) - max(start, gap_start)
                if overlap > 0:
                    label = _label(name, names)
                    totals[label] = totals.get(label, 0) + overlap
                    covered += overlap
                i += 1
            if gap_end - gap_start > covered:
                totals["between requests"] = (totals.get("between requests", 0)
                                              + gap_end - gap_start - covered)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
        return [[label, total / 1e9] for label, total in ranked]


def _label(name, names):
    if name.startswith("step "):
        return names.get(int(name.split()[1]), name)
    return name

