#!/usr/bin/env python3
"""Probe of ``Simulation.run``'s CUDA-graph replay of the pairs step
against its loop, on one NVIDIA GPU, at the 1M-particle temperature pore
(pairs K = 8, 100-step epochs).

For each path, a fresh ``Simulation`` and process-wide peak: the first
epoch (set-up's share: the graphs' eager steps and captures), then
``EPOCHS`` epochs of ``run`` + ``io.metrics.epoch_to_host`` on the host's
clock, and ``torch.cuda.max_memory_allocated``.  For the replay also: the
bytes each capture leaves allocated, the tensors a step copies back into
the graphs' inputs (their bytes, the program's own mean a step where it
counts them, and the device time of the same copies by CUDA events), a window of replays by CUDA events, and a profiled
window of replays (device time a step, ops a step, the top kernels).

Run from the repository root:

    python3 scripts/torch_step_graphs.py [particles] [epochs]

Prints the card's name and power limit first; the last line is JSON.
"""

import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argon_monte_carlo_tpu_torch as amt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from argon_monte_carlo_tpu_torch import engine, kernels  # noqa: E402
from argon_monte_carlo_tpu_torch.io import metrics as metrics_io  # noqa: E402

SEED, K, SPE = 3000000101, 8, 100


def simulation(n: int) -> amt.Simulation:
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=K,
        steps_per_epoch=SPE)).scaled_to(n)
    return amt.Simulation(amt.make_workload(cfg), device="cuda")


def run_path(n: int, epochs: int, replay: bool) -> dict:
    rule = engine.replays_steps
    if not replay:
        engine.replays_steps = lambda *args: False
    captures, copies, in_body = [], [], [False]
    capture, body, copy_into = (engine.StepGraphs._capture,
                                engine.StepGraphs.run_body,
                                engine.copy_into)

    def counted_capture(self, rebuilt):
        before = torch.cuda.memory_allocated()
        out = capture(self, rebuilt)
        captures.append((rebuilt, torch.cuda.memory_allocated() - before))
        return out

    def flagged_body(self, rebuilt):
        in_body[0] = True
        try:
            body(self, rebuilt)
        finally:
            in_body[0] = False

    def logged_copy(static, obj):
        if in_body[0] and not torch.cuda.is_current_stream_capturing():
            copies.append([d.numel() * d.element_size() for d, s in (
                (getattr(static, f), getattr(obj, f))
                for f in obj.__dataclass_fields__)
                if d.data_ptr() != s.data_ptr()])
        return copy_into(static, obj)

    engine.StepGraphs._capture = counted_capture
    engine.StepGraphs.run_body = flagged_body
    engine.copy_into = logged_copy
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = simulation(n)
        state, measure, gen = sim.init(SEED)
        t0 = time.perf_counter()
        state, measure, m = sim.run(SPE, state=state, measure=measure,
                                    generator=gen)
        metrics_io.epoch_to_host(m)
        first_s = time.perf_counter() - t0
        epoch_s = []
        step = SPE
        for _ in range(epochs):
            t = time.perf_counter()
            state, measure, m = sim.run(SPE, state=state, measure=measure,
                                        generator=gen, start_step=step)
            metrics_io.epoch_to_host(m)
            epoch_s.append(time.perf_counter() - t)
            step += SPE
        peak = torch.cuda.max_memory_allocated()
    finally:
        engine.replays_steps = rule
        engine.StepGraphs._capture = capture
        engine.StepGraphs.run_body = body
        engine.copy_into = copy_into
    med = statistics.median(epoch_s)
    out = {"path": "replay" if replay else "loop", "n": n,
           "first_epoch_s": first_s, "epoch_s_median": med,
           "epoch_s_q": statistics.quantiles(epoch_s, n=4),
           "particle_steps_per_s": n * SPE / med, "peak_bytes": peak,
           "replayed": sim.replayed_steps, "looped": sim.looped_steps}
    if replay:
        out["capture_live_bytes"] = captures
        # The bytes each ``copy_into`` of the two eager bodies copied: the
        # step with the rebuild (the new list, then the step's state,
        # measurements and list), then a plain step (the same three).
        out["copy_back_bytes"] = copies
        # The program's own counter of the same (a program without it:
        # None).
        out["copy_back_bytes_per_step"] = getattr(
            sim, "copy_back_bytes_per_step", None)
        out.update(graph_window(sim, gen, copies))
    return out


def graph_window(sim, gen, copies) -> dict:
    g = sim._graphs
    steps = 10 * K

    def window():
        g.cursor.zero_()
        for i in range(steps):
            g.uniforms.uniform_(generator=gen)
            g.step(i % K == 0)

    window()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    window()
    end.record()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    kern = Counter()
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.name[:90]] += e.time_range.end - e.time_range.start
            count += 1
    busy_ms = sum(kern.values()) / 1e3 / steps
    copy_ms = sum(v for k, v in kern.items()
                  if "copy" in k.lower() or "Memcpy" in k) / 1e3 / steps
    # A plain step's copy-backs alone, by CUDA events: buffers of its sizes
    # copied the way the body copies them.
    bufs = [(torch.empty(b, dtype=torch.uint8, device="cuda"),
             torch.empty(b, dtype=torch.uint8, device="cuda"))
            for b in sum(copies[-3:], [])]
    copy_event_ms = cs.timed_ms(lambda: [d.copy_(s) for d, s in bufs], 20)
    g.cursor.zero_()
    return {"replay_window_event_ms_per_step": event_ms,
            "replay_window_host_ms_per_step": host_s * 1e3 / steps,
            "profiled_device_ms_per_step": busy_ms,
            "profiled_ops_per_step": count / steps,
            "profiled_copy_kernels_ms_per_step": copy_ms,
            "plain_step_copy_backs_event_ms": copy_event_ms,
            "top_kernels_ms_per_step": [(k, v / 1e3 / steps)
                                        for k, v in kern.most_common(12)]}


def main(argv) -> int:
    n = int(argv[0]) if argv else 1_000_000
    epochs = int(argv[1]) if len(argv) > 1 else 20
    card = cs.card_line()
    print(card)
    kernels.library()
    results = []
    for replay in (False, True, True, False):
        r = run_path(n, epochs, replay)
        print({k: v for k, v in r.items() if k != "top_kernels_ms_per_step"})
        if "top_kernels_ms_per_step" in r:
            for name, ms in r["top_kernels_ms_per_step"]:
                print(f"  {ms:.5f} ms/step  {name}")
        results.append(r)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
