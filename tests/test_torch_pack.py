"""Port vs reference: the plain versions of K12, ``pack_band_plain`` and
``pack_indices_plain``, against ``_compact_band`` and ``_compact_idx`` of
the JAX package's sharded engine on the same numpy-seeded inputs.

Everything is a copy or an integer, so every comparison is exact: the
buffers (kept rows in ascending lane order, then the fill -- the far
sentinel 1e9 for ``pos``, 0 elsewhere, n for the index form), the flags and
the number of lanes dropped.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu.parallel import shard as jshard
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.ops import pack as tpack

N = 1000
DTYPES = {"float32": np.float32, "float64": np.float64}


def make_mask(density, rng):
    if density == 0:
        return np.zeros(N, bool)
    if density == 1:
        return np.ones(N, bool)
    return rng.random(N) < density


def capacity_for(room, count):
    return {"above": count + 5, "equal": count, "below": count // 2}[room]


def make_fields(rng, dtype):
    """The migration payload's fields: floats of the run's dtype, a bool
    and an int32 column."""
    return {
        "pos": rng.normal(size=(N, 3)).astype(dtype),
        "vel": (rng.normal(size=(N, 3)) * 300).astype(dtype),
        "paths": rng.uniform(0, 1e-6, (N, 4)).astype(dtype),
        "hc": rng.random(N) < 0.5,
        "gid": rng.permutation(N).astype(np.int32),
    }


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("room", ["above", "equal", "below"])
@pytest.mark.parametrize("density", [0, 0.01, 0.5, 1])
def test_pack_band_plain_matches_reference(density, room, dtype):
    rng = np.random.default_rng(7)
    mask = make_mask(density, rng)
    count = int(mask.sum())
    capacity = capacity_for(room, count)
    fields = make_fields(rng, DTYPES[dtype])

    want, dropped_j = jshard._compact_band(
        {k: jnp.asarray(v) for k, v in fields.items()}, jnp.asarray(mask),
        capacity)
    buf, flag, dropped = tpack.pack_band_plain(
        {k: torch.from_numpy(v) for k, v in fields.items()},
        torch.from_numpy(mask), capacity)

    assert set(buf) == set(fields)
    for name, arr in fields.items():
        got = buf[name].numpy()
        assert got.dtype == arr.dtype and got.shape == (capacity,) + arr.shape[1:]
        np.testing.assert_array_equal(got, np.asarray(want[name]), err_msg=name)
    assert flag.dtype == torch.bool and dropped.dtype == torch.int32
    np.testing.assert_array_equal(flag.numpy(), np.asarray(want["flag"]))
    assert int(dropped) == int(dropped_j) == max(count - capacity, 0)
    kept = min(count, capacity)
    assert int(flag.sum()) == kept
    # The kept rows are the lowest lanes in ascending order; the rest is
    # the fill.
    lanes = np.nonzero(mask)[0][:kept]
    np.testing.assert_array_equal(buf["gid"].numpy()[:kept],
                                  fields["gid"][lanes])
    assert (buf["pos"].numpy()[kept:] == DTYPES[dtype](tpack.SENTINEL)).all()
    assert not buf["vel"].numpy()[kept:].any()


@pytest.mark.parametrize("room", ["above", "equal", "below"])
@pytest.mark.parametrize("density", [0, 0.01, 0.5, 1])
def test_pack_indices_plain_matches_reference(density, room):
    rng = np.random.default_rng(8)
    mask = make_mask(density, rng)
    count = int(mask.sum())
    capacity = capacity_for(room, count)
    idx_j, flag_j, dropped_j = jshard._compact_idx(jnp.asarray(mask),
                                                   capacity)
    idx, flag, dropped = tpack.pack_indices_plain(torch.from_numpy(mask),
                                                  capacity)
    assert idx.dtype == torch.int32 and dropped.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(flag.numpy(), np.asarray(flag_j))
    assert int(dropped) == int(dropped_j) == max(count - capacity, 0)
    assert (idx.numpy()[min(count, capacity):] == N).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU mask runs the plain version (no launch); any other device
    than the CPU or CUDA raises instead of falling back."""
    rng = np.random.default_rng(9)
    mask = torch.from_numpy(rng.random(N) < 0.2)
    fields = {k: torch.from_numpy(v)
              for k, v in make_fields(rng, np.float32).items()}
    before = dict(kernels.launch_counts)
    buf, flag, dropped = tpack.pack_band(fields, mask, 64)
    want, want_flag, want_dropped = tpack.pack_band_plain(fields, mask, 64)
    for name in fields:
        assert torch.equal(buf[name], want[name])
    assert torch.equal(flag, want_flag) and int(dropped) == int(want_dropped)
    for got, ref in zip(tpack.pack_indices(mask, 64),
                        tpack.pack_indices_plain(mask, 64)):
        assert torch.equal(got, ref)
    assert dict(kernels.launch_counts) == before
    with pytest.raises(ValueError, match="plain version runs on the CPU"):
        tpack.pack_indices(mask.to("meta"), 64)


def declared_signatures():
    """Argument kinds of each exported kernel function, read from the C
    declarations."""
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    declared = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r"AMC_EXPORT int amc_(\w+)\((.*?)\)\s*\{", src.read_text(),
                re.S):
            kinds = ["P" if "*" in p or "cudaStream_t" in p
                     else "F" if p.split()[0] == "float" else "I"
                     for p in params.split(",")]
            declared[name] = [types[k] for k in kinds]
    return declared


@pytest.mark.parametrize("name", ["pack_band", "pack_indices"])
def test_pack_signatures_match_source(name):
    """The ctypes argument table equals pack.cu's declarations, stream
    last."""
    assert declared_signatures()[name] == kernels._SIGNATURES[name]
    assert "amc_" + name in (kernels.CSRC / "pack.cu").read_text()


def test_pack_wrappers_pass_declared_arguments(monkeypatch):
    """Forced down their kernel side with the launch intercepted, the
    wrappers pass exactly the declared argument kinds; a float64 field or
    a sixth field is refused."""
    calls = []

    def fake_launch(name, device, *args):
        calls.append((name, args))
        sig = kernels._SIGNATURES[name][:-1]  # the stream is launch's
        assert len(args) == len(sig), name
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (name, arg, kind)

    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    rng = np.random.default_rng(10)
    mask = torch.from_numpy(rng.random(N) < 0.2)
    fields = {k: torch.from_numpy(v)
              for k, v in make_fields(rng, np.float32).items()}
    buf, flag, _ = tpack.pack_band(fields, mask, 64)
    assert buf["pos"].shape == (64, 3) and buf["hc"].dtype == torch.bool
    assert flag.shape == (64,)
    tpack.pack_band({"pos": fields["pos"], "gid": fields["gid"]}, mask, 8)
    tpack.pack_indices(mask, 32)
    assert [c[0] for c in calls] == ["pack_band", "pack_band",
                                     "pack_indices"]
    # n, capacity, number of fields; row bytes, element bytes and the
    # fill's bit pattern of pos (1e9 as float32) and of has_collided.
    args = calls[0][1]
    assert args[1:4] == (N, 64, 5)
    assert args[6:9] == (12, 4, 0x4E6E6B28)
    assert args[21:24] == (1, 1, 0)
    assert calls[1][1][3] == 2
    with pytest.raises(TypeError, match="float32, int32 and bool"):
        tpack.pack_band({"pos": fields["pos"].double()}, mask, 8)
    with pytest.raises(ValueError, match="at most"):
        tpack.pack_band({str(k): fields["gid"] for k in range(6)}, mask, 8)
