"""The readers of the program's own spans (``program_spans``): on a
made-up trace, an ``amc/`` span's range on the device's timeline is no
device op, device ops are tied to the ``amc/`` spans that launched them,
and host ops nested in another count once; on the CPU, a traced run reads
the host's metrics, and a program that records no span leaves them out."""

import time
import types

import pytest
import torch

import harness
import program_spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SEED = "4000000019"
CELLS = ["tpore-1m.pairs", "tpore-1m.sweep", "cube.allpairs"]
HOST = {"host_ms_per_step": "ms/step", "host_ops_per_step": "ops/step"}
CARD = ("launch_host_us", "glue_ops_per_step")


def event(name, start, end, device=CPU, id=0, thread=1, link=0):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, thread=thread,
        linked_correlation_id=link,
        time_range=types.SimpleNamespace(start=start, end=end))


class FakeProfile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def trace():
    return FakeProfile([
        event("amc/epoch", 0.0, 100.0),
        event("amc/step", 1.0, 90.0),
        event("aten::add", 2.0, 10.0),
        event("aten::empty", 3.0, 4.0),           # nested in aten::add
        event("cudaLaunchKernel", 5.0, 6.0, id=7),
        event("amc/launch", 20.0, 30.0),
        event("cudaLaunchKernel", 22.0, 23.0, id=8),
        event("aten::stack", 40.0, 50.0),
        event("aten::cat", 41.0, 49.0),            # nested in aten::stack
        event("aten::zeros", 120.0, 121.0),        # after the epoch
        event("aten::ones", 130.0, 131.0, thread=2),  # another thread
        # The device's timeline: two kernels and a span's range.
        event("vectorized_elementwise_kernel", 8.0, 12.0, CUDA, id=7),
        event("my_kernel", 25.0, 35.0, CUDA, id=8),
        event("amc/launch", 22.0, 36.0, CUDA),
    ])


def slice_of(prof):
    t = types.SimpleNamespace(steps=1, window_s=1e-4, untraced_step_s=5e-5,
                              traffic={}, seed=0)
    return program_spans.reduce(prof, t)


def test_program_spans_are_no_device_ops():
    s = slice_of(trace())
    assert [e.short for e in s.traced.events] == [
        "vectorized_elementwise_kernel", "my_kernel"]
    assert s.traced.busy_s == (4.0 + 10.0) * 1e-6
    assert s.traced.calls == {"amc/epoch": 1, "amc/step": 1,
                              "amc/launch": 1}
    glue, kernel = s.traced.events
    assert glue.spans == {"amc/epoch", "amc/step"}
    assert kernel.spans == {"amc/epoch", "amc/step", "amc/launch"}
    names = [h[2] for h in s.host]
    assert "cudaLaunchKernel" not in names and "amc/launch" in names
    assert "aten::ones" not in names


def test_readers_of_the_program_spans():
    s = slice_of(trace())
    assert s.spans("amc/launch") == [(20.0, 30.0)]
    # aten::add and aten::stack; their children and the op after the epoch
    # are left out.
    assert s.top_host_ops(inside="amc/epoch") == 2
    assert s.traced.ops(span="amc/epoch", outside="amc/launch") == 1


def test_a_trace_without_the_program_spans_is_nothing_to_read():
    prof = FakeProfile([e for e in trace()._events
                        if not e.name.startswith("amc/")])
    assert slice_of(prof) is None


def traced_run(small_bench, workload):
    return harness.run_cell(
        ["--workload", workload, "--seed", SEED, "--seconds", "0.1",
         "--trace", "1"], time.perf_counter(), device="cpu",
        bench_dir=small_bench)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reads_the_program_spans(small_bench, workload):
    """Host time and host ops a step on the CPU; no launch and no device
    op there."""
    out = traced_run(small_bench, workload)
    assert out["correct"] is True
    got = out["metrics"]
    assert {k: got[k]["unit"] for k in HOST} == HOST
    assert all(got[k]["value"] > 0.0 for k in HOST)
    assert not any(k in got for k in CARD)


def test_a_program_without_spans_leaves_their_metrics_out(small_bench,
                                                          monkeypatch):
    from argon_monte_carlo_tpu_torch import trace as program_trace
    monkeypatch.setattr(program_trace, "profiling", lambda: False)
    out = traced_run(small_bench, "tpore-1m.pairs")
    assert out["correct"] is True
    assert not any(k in out["metrics"] for k in (*HOST, *CARD))
