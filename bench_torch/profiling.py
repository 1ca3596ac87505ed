"""The traced slice: spans around the program's layer entries, and the
reduction of a ``torch.profiler`` trace to device events, each attributed
to the spans whose host interval launched it.

A span is named by what it wraps:

- ``Simulation.<attr>``: an attribute of the ``Simulation`` the benchmark
  builds (``run``, ``_step``), replaced on that instance;
- ``Workload.<field>``: a field of the workload the benchmark builds
  (``advance``), replaced before the ``Simulation`` is made, since the
  step functions hold the workload;
- ``<module path>.<function>`` under the program's package
  (``ops.pairs.rebuild``, ``ops.collide.partner_sweep``): the module's
  attribute, which the engine looks up at each call.

Wrappers enter their ``record_function`` only while ``Spans.active`` is
set, so set-up and the untraced window run through a bare call.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import re
from collections import Counter, defaultdict

import torch

PACKAGE = "argon_monte_carlo_tpu_torch"
# Host calls that launch device work, matched to the device events they
# made by correlation id.
_RUNTIME = ("cuda", "cu")


class Spans:
    """The wrappers of one process, off until ``active`` is set."""

    def __init__(self):
        self.active = False
        self.names: set = set()

    def wrap(self, fn, name: str):
        self.names.add(name)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    def on_workload(self, workload, names):
        """The workload with its named fields wrapped."""
        fields = {}
        for name in names:
            if name.startswith("Workload."):
                attr = name.split(".", 1)[1]
                fields[attr] = self.wrap(getattr(workload, attr), name)
        return dataclasses.replace(workload, **fields) if fields else workload

    def on_simulation(self, sim, names):
        for name in names:
            if name.startswith("Simulation."):
                attr = name.split(".", 1)[1]
                setattr(sim, attr, self.wrap(getattr(sim, attr), name))

    def on_modules(self, names):
        for name in names:
            if name.startswith(("Simulation.", "Workload.")):
                continue
            path, attr = name.rsplit(".", 1)
            mod = importlib.import_module(f"{PACKAGE}.{path}")
            setattr(mod, attr, self.wrap(getattr(mod, attr), name))


def short_name(name: str) -> str:
    """A device event's kernel name without its signature
    ('void at::native::elementwise_kernel<...>(...)' ->
    'elementwise_kernel'; 'Memcpy DtoH (Device -> Pinned)' ->
    'Memcpy DtoH')."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    s = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", s)
    return m.group(1) if m else s[:48]


def has_kernel(full: str, kernel: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])",
                     full) is not None


@dataclasses.dataclass
class DeviceEvent:
    name: str          # the full name
    short: str
    start_us: float
    end_us: float
    spans: frozenset   # the spans whose host interval launched it

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


class _Intervals:
    """Non-overlapping intervals of one span name, sorted by start."""

    def __init__(self, ivs):
        self.ivs = sorted(ivs)
        self.starts = [a for a, _ in self.ivs]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.ivs[i][1] >= t


def reduce(prof, span_names) -> dict:
    """Device events with their spans, span call counts, device busy time
    (the union of the events' intervals), the breakdown's host ops."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in events:
        if e.device_type != cuda:
            cpu.append(e)
        elif e.name not in span_names:
            # (a span's own range on the device's timeline is no work)
            dev.append(e)
    spans = defaultdict(list)
    main_threads = Counter()
    for e in cpu:
        if e.name in span_names:
            spans[e.name].append((e.time_range.start, e.time_range.end))
            main_threads[e.thread] += 1
    main = main_threads.most_common(1)[0][0] if main_threads else None
    by_span = {k: _Intervals(v) for k, v in spans.items()}
    runtime = {e.id: e for e in cpu if e.name.startswith(_RUNTIME)}
    frontend = {e.id: e for e in cpu}
    out, unmatched = [], 0
    for d in dev:
        src = runtime.get(d.id) or frontend.get(
            getattr(d, "linked_correlation_id", 0) or -1)
        if src is None:
            unmatched += 1
            inside = frozenset()
        else:
            t = src.time_range.start
            inside = frozenset(k for k, iv in by_span.items()
                               if iv.contains(t))
        out.append(DeviceEvent(d.name, short_name(d.name),
                               d.time_range.start, d.time_range.end,
                               inside))
    out.sort(key=lambda e: e.start_us)
    busy, end = 0.0, -float("inf")
    for e in out:
        if e.end_us > end:
            busy += e.end_us - max(e.start_us, end)
            end = e.end_us
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in cpu if e.thread == main
                   and not e.name.startswith(_RUNTIME)),
                  key=lambda x: x[0])
    return dict(events=out, calls={k: len(v) for k, v in spans.items()},
                busy_s=busy * 1e-6, unmatched=unmatched, host=host)


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device, summed by the innermost host op over each."""
    by_name = Counter()
    for e in reduced["events"]:
        by_name[e.short] += e.seconds
    host = reduced["host"]
    starts = [h[0] for h in host]
    gaps = Counter()
    ev = reduced["events"]
    spans_of = []
    for a, b in zip(ev, ev[1:]):
        if b.start_us > a.end_us:
            spans_of.append((b.start_us - a.end_us, a.end_us, b.start_us))
    spans_of.sort(reverse=True)
    for length, lo, hi in spans_of[:4000]:
        mid = 0.5 * (lo + hi)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host (no op)"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] += length * 1e-6
    return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


@dataclasses.dataclass
class Traced:
    """What a per-layer reader reads: the traced slice's device events and
    span calls, its steps and times, the untraced step time of the same
    process, and the run's objects for the counts (the state after the
    slice, the ``Simulation``, the reference's setup of the config, the
    traffic mix, the run's seed)."""

    events: list
    calls: dict
    steps: int
    busy_s: float
    window_s: float
    untraced_step_s: float
    state: object
    sim: object
    setup: object
    traffic: dict
    seed: int

    def select(self, span=None, kernels=None, outside=None):
        for e in self.events:
            if span is not None and span not in e.spans:
                continue
            if outside is not None and outside in e.spans:
                continue
            if kernels is not None and not any(has_kernel(e.name, k)
                                               for k in kernels):
                continue
            yield e

    def device_s(self, **kw) -> float:
        return sum(e.seconds for e in self.select(**kw))

    def ops(self, **kw) -> int:
        return sum(1 for _ in self.select(**kw))
