"""Checkpoints with exact resume (port of
``argon_monte_carlo_tpu.io.checkpoint``).

The full simulation state -- particles, path accumulators, measurement
accumulators, the step index and the random generator's state --
round-trips through one ``.npz`` file under the reference's field names,
so either package reads the other's particles and accumulators.

The reference resumes bit-exactly because a step's key is
``fold_in(run_key, step)``.  The port draws every step's uniforms from a
stateful ``torch.Generator``, so its file also holds that generator's
state (``generator_state``, uint8; ``generator_device``, "cuda" or
"cpu"): restored with ``set_state``, the generator draws from step k on
exactly what the uninterrupted run drew.  ``run_key`` is written as a zero
(2,) uint32 for the reference's loader.  A file the reference wrote has no
generator state: it loads with a generator seeded from its ``run_key`` and
``step`` (``reference_seed``), and the continuation draws from the port's
generator, not the reference's keys (``written_by_reference``).  A state
saved by a generator of one device kind never resumes on the other: the
two kinds draw different streams, so loading raises.

A pairs run's file also holds its carried pair list (``pairs_<field>``)
and the steps left in its window (``pairs_window_left``): the resumed run
continues that window and rebuilds on the uninterrupted run's steps.  A
rebuild at the resume step instead is trajectory-neutral only while no
one-step latency of the pairs engine (a full emission, a table spill)
falls in the window; at 557,649 molecules one does.

The sharded file keeps the reference's flat lane layout (slabs
concatenated into ``(S * capacity, ...)``, ``valid``, ``gid``,
``sharded``, the measurements as ``m_<field>`` stacked on a leading
``(S,)`` axis) and one generator state a slab, ``(S, L)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import convert
from ..ops.pairs import PairList
from ..state import Measurements, ParticleState

STATE_FIELDS = ("pos", "vel", "paths", "has_collided")
# The reference's single-run measurement fields (checkpoint.py:22-35).
MEASURE_FIELDS = ("hist", "path_sum", "path_count", "collision_count",
                  "err_count", "overflow_count", "halo_trunc_count",
                  "hist_drop_count", "hot_spill_count")
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def reference_seed(run_key, step: int, slab: int | None = None) -> int:
    """The port generator's seed for a reference file's (run_key, step[,
    slab]): a SeedSequence of those words, 64 bits."""
    words = [int(w) for w in np.asarray(run_key).astype(np.uint64).ravel()]
    words.append(int(step))
    if slab is not None:
        words.append(int(slab))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def written_by_reference(path: str) -> bool:
    """True for a file without the port's generator state (one the
    reference package wrote)."""
    with np.load(path) as z:
        return "generator_state" not in z.files


def _generator_arrays(generators) -> dict:
    kinds = [g.device.type for g in generators]
    states = [g.get_state().numpy() for g in generators]
    if len({s.shape for s in states}) != 1:
        raise ValueError(f"generators on {sorted(set(kinds))} devices: one "
                         "checkpoint holds one kind of generator state")
    return {"generator_state": np.stack(states),
            "generator_device": np.asarray(kinds)}


def _check_kind(saved_kinds, devices, path: str) -> None:
    """Raise unless each saved generator state resumes on a device of the
    kind that saved it."""
    for kind, device in zip(saved_kinds, devices):
        kind, want = str(kind), torch.device(device).type
        if kind != want:
            raise ValueError(
                f"{path}: the generator state was saved on a {kind} device "
                f"and cannot resume on a {want} device: the two kinds draw "
                f"different streams (resume with device='{kind}')")


def _restore(device, saved_state, seed: int) -> torch.Generator:
    """A generator on ``device`` in the saved state (or seeded with
    ``seed`` where nothing was saved)."""
    gen = torch.Generator(device=torch.device(device))
    if saved_state is None:
        gen.manual_seed(seed)
    else:
        gen.set_state(torch.from_numpy(np.ascontiguousarray(saved_state)))
    return gen


def save_checkpoint(path: str, state: ParticleState, measure: Measurements,
                    generator: torch.Generator, step: int,
                    pair_window=None) -> str:
    """One ``Simulation``'s state at ``step`` and the generator that draws
    its next steps; in pairs mode also ``pair_window`` (the carried pair
    list and the steps left in its window, ``Simulation.pair_window()``),
    so that the resumed run rebuilds where the uninterrupted run does."""
    arrays = {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
    arrays.update({f: getattr(measure, f).cpu().numpy()
                   for f in MEASURE_FIELDS})
    if pair_window is not None:
        plist, window_left = pair_window
        arrays.update({f"pairs_{f.name}": getattr(plist, f.name).cpu().numpy()
                       for f in dataclasses.fields(plist)})
        arrays["pairs_window_left"] = np.asarray(window_left)
    gen = _generator_arrays([generator])
    np.savez_compressed(
        path, **arrays, run_key=np.zeros(2, np.uint32), step=np.asarray(step),
        generator_state=gen["generator_state"][0],
        generator_device=gen["generator_device"][0])
    return path


def load_checkpoint(path: str, device="cpu"):
    """Returns (state, measure, generator, step) on ``device``; the
    staging is empty (it always is between steps)."""
    with np.load(path) as z:
        arrays = {f: z[f] for f in z.files}
    saved = arrays.get("generator_state")
    if saved is not None:
        _check_kind([arrays["generator_device"]], [device], path)
    dtype = _DTYPES[arrays["paths"].dtype]
    n = arrays["pos"].shape[0]
    arrays["pending_vals"] = np.zeros((n, 4), arrays["paths"].dtype)
    arrays["pending_mask"] = np.zeros((n,), bool)
    state, measure = convert.state_from_numpy(arrays, device, dtype)
    step = int(arrays["step"])
    generator = _restore(device, saved,
                         reference_seed(arrays["run_key"], step))
    return state, measure, generator, step


def load_pair_window(path: str, device="cpu"):
    """(PairList, steps left in its window) saved with a pairs run's
    state, on ``device``, or None where the file has none (a sweep run's,
    or the reference's)."""
    with np.load(path) as z:
        if "pairs_window_left" not in z.files:
            return None
        plist = PairList(**{
            f.name: torch.as_tensor(z[f"pairs_{f.name}"], device=device)
            for f in dataclasses.fields(PairList)})
        return plist, int(z["pairs_window_left"])


def save_sharded_checkpoint(path: str, state, measure, generators,
                            step: int) -> str:
    """A ``ShardedSimulation``'s per-slab lists in the reference's flat
    layout, with each slab's generator state."""
    flat = convert.sharded_state_to_numpy(state, measure)
    names = [f.name for f in dataclasses.fields(Measurements)]
    np.savez_compressed(
        path,
        **{k: flat[k] for k in (*STATE_FIELDS, "valid", "gid")},
        **{f"m_{k}": flat[k] for k in names},
        sharded=np.asarray(True), run_key=np.zeros(2, np.uint32),
        step=np.asarray(step), **_generator_arrays(generators))
    return path


def load_sharded_checkpoint(path: str, devices):
    """Returns (state, measure, generators, step): the per-slab lists on
    ``devices`` (one a slab; the file's lanes split evenly over them)."""
    with np.load(path) as z:
        arrays = {(k[2:] if k.startswith("m_") else k): z[k]
                  for k in z.files}
    saved = arrays.get("generator_state")
    if saved is not None:
        if saved.shape[0] != len(devices):
            raise ValueError(f"{path}: {saved.shape[0]} slab generators for "
                             f"{len(devices)} slabs")
        _check_kind(arrays["generator_device"], devices, path)
    dtype = _DTYPES[arrays["paths"].dtype]
    state, measure = convert.sharded_state_from_numpy(arrays, devices, dtype)
    step = int(arrays["step"])
    generators = [
        _restore(dev, None if saved is None else saved[s],
                 reference_seed(arrays["run_key"], step, s))
        for s, dev in enumerate(devices)]
    return state, measure, generators, step
