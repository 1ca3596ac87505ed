"""Structured metrics logging (JSONL) (port of
``argon_monte_carlo_tpu.io.metrics``).

Replaces the reference's print-based observability (per-step collision
counts, OOB counts, phase runtimes; Open_Air_Pore_MC.py:512-557) with one
machine-readable record an epoch; the time of each phase is in the spans
that ``trace`` records under ``torch.profiler``.  An epoch's
``StepMetrics`` stay on the device while it runs; ``epoch_to_host`` reads
them back in one copy.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO, Optional

import numpy as np
import torch


def epoch_to_host(metrics) -> dict:
    """{field: numpy array} of an epoch's stacked ``StepMetrics``, read to
    the host as ONE copy: every field is widened to float64 (exact for the
    int32 counts and float32 ledger), concatenated along the step axis on
    the device, copied once, and cut back into each field's shape and
    dtype.  A dict passes through."""
    if isinstance(metrics, dict):
        return metrics
    fields = [(f.name, getattr(metrics, f.name))
              for f in dataclasses.fields(metrics)]
    steps = fields[0][1].shape[0]
    block = torch.cat([t.reshape(steps, -1).to(torch.float64)
                       for _, t in fields], dim=1).cpu().numpy()
    out, col = {}, 0
    for name, t in fields:
        width = int(np.prod(t.shape[1:], dtype=np.int64))
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out[name] = block[:, col:col + width].astype(dtype).reshape(t.shape)
        col += width
    return out


def device_memory_stats(device) -> dict:
    """Device-memory telemetry under the reference's keys: bytes in use
    and their peak (the caching allocator's), the card's total memory as
    ``bytes_limit``, and the allocations made.  {} for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
        "num_allocs": int(stats.get("allocation.all.allocated", 0)),
    }


class MetricsLogger:
    """JSONL writer for per-epoch simulation metrics.

    ``resume=False`` (a fresh run) truncates any stale file so records
    from a previous run in the same out-dir never interleave; ``resume=
    True`` appends.  Throughput is reported per epoch window (time since
    the previous record in THIS session), so it is meaningful across
    resumes; ``session_particle_steps_per_sec`` is the running session
    aggregate.  ``device`` (a CUDA device) adds ``device_memory``.
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 resume: bool = False, device=None):
        self._fh = open(path, "a" if resume else "w") if path else stream
        self._device = device
        self._t0 = time.time()
        self._last = self._t0
        self._steps_done = 0

    def log_epoch(self, metrics, num_particles: int,
                  first_step: int) -> dict:
        """One record for an epoch's metrics (``StepMetrics`` of stacked
        tensors, or ``epoch_to_host``'s dict of them)."""
        m = epoch_to_host(metrics)
        n_steps = int(m["collisions"].shape[0])
        self._steps_done += n_steps
        now = time.time()
        window = max(now - self._last, 1e-9)
        self._last = now
        record = {
            "time": now,
            "elapsed_s": now - self._t0,
            "first_step": int(first_step),
            "steps": n_steps,
            "collisions": int(m["collisions"].sum()),
            "wall_hits": int(m["wall_hits"].sum()),
            "momentum_z_sum": float(m["momentum_z"].sum()),
            "energy_hot_sum": float(m["energy_hot"].sum()),
            "energy_cold_sum": float(m["energy_cold"].sum()),
            "oob_after_walls": int(m["oob_after_walls"].sum()),
            "oob_after_pairs": int(m["oob_after_pairs"].sum()),
            # The pairs engine's counters (zeros in the sweep): epoch sums
            # of the rebuild, dirty and latency counters (state.py).
            "rebuilds": int(m["rebuilt"].sum()),
            "dirty_count": int(m["dirty_count"].sum()),
            "latent_full": int(m["latent_full"].sum()),
            "teleports": int(m["teleports"].sum()),
            "latent_research": int(m["latent_research"].sum()),
            "particle_steps_per_sec": n_steps * num_particles / window,
            "session_particle_steps_per_sec": (
                self._steps_done * num_particles / max(now - self._t0, 1e-9)
            ),
        }
        mem = device_memory_stats(self._device) if self._device else {}
        if mem:
            record["device_memory"] = mem
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return record

    def close(self):
        if self._fh is not None:
            self._fh.close()

