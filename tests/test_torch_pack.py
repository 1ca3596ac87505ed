"""Port vs reference: the plain versions of K12, ``pack_band_plain``,
``pack_indices_plain`` and the two-direction ``pack_band_pair_plain``,
against ``_compact_band`` and ``_compact_idx`` of the JAX package's sharded
engine on the same numpy-seeded inputs (the two-direction form against two
``_compact_band`` calls on the masks the reference's step builds).

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


PAIR_CASES = ["room", "truncated", "capacity-0", "empty", "no-up",
              "no-down"]


def edge_lanes(rng, dtype):
    """The payload's fields and valid over N lanes, with an up and a down
    edge that three valid lanes each sit on or one ulp either side of."""
    fields = make_fields(rng, dtype)
    valid = rng.random(N) < 0.9
    z = fields["pos"][:, 2]
    up, down = dtype(0.9), dtype(-0.8)
    for lane, value in ((10, up), (11, np.nextafter(up, dtype(np.inf))),
                        (12, np.nextafter(up, dtype(-np.inf))),
                        (20, down), (21, np.nextafter(down, dtype(np.inf))),
                        (22, np.nextafter(down, dtype(-np.inf)))):
        z[lane] = value
        valid[lane] = True
    return fields, valid, up, down


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("inclusive", [False, True], ids=["halo", "migrants"])
@pytest.mark.parametrize("case", PAIR_CASES)
def test_pack_band_pair_plain_matches_reference(case, inclusive, dtype):
    """Both directions of one exchange at once, against two
    ``_compact_band`` calls on the reference's masks: ``valid & (z >
    z_hi - halo_width)`` / ``valid & (z < z_lo + halo_width)`` for the halo,
    ``valid & (z >= z_hi) & (me < n_shards - 1)`` / ``valid & (z < z_lo) &
    (me > 0)`` for the migrants (shard.py:410-417, 479-486).  Lanes on an
    edge and one ulp either side go the reference's way; a side without a
    neighbour packs nothing; capacity 0, no lane selected and a truncated
    capacity give the reference's fills, flags and dropped."""
    np_dtype = DTYPES[dtype]
    rng = np.random.default_rng(12)
    fields, valid, up, down = edge_lanes(rng, np_dtype)
    if case == "empty":
        up, down = np_dtype(50.0), np_dtype(-50.0)
    up_edge = None if case == "no-up" else up
    down_edge = None if case == "no-down" else down

    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    jz, jvalid = jf["pos"][:, 2], jnp.asarray(valid)
    nobody = jnp.zeros(N, bool)
    if up_edge is None:
        jup = nobody
    elif inclusive:
        jup = jvalid & (jz >= jnp.asarray(up_edge))
    else:
        jup = jvalid & (jz > jnp.asarray(up_edge))
    jdown = nobody if down_edge is None else jvalid & (jz < jnp.asarray(
        down_edge))
    count = max(int(jup.sum()), int(jdown.sum()))
    capacity = {"truncated": max(count // 2, 1), "capacity-0": 0}.get(
        case, count + 3)

    t = {k: torch.from_numpy(v) for k, v in fields.items()}
    as_t = (lambda e: None if e is None
            else torch.tensor(e, dtype=t["pos"].dtype))
    up_t, down_t, rest = tpack.pack_band_pair_plain(
        t, torch.from_numpy(valid), capacity, as_t(up_edge), as_t(down_edge),
        up_inclusive=inclusive, rest=True)
    for (buf, flag, dropped), jmask in ((up_t, jup), (down_t, jdown)):
        want, dropped_j = jshard._compact_band(jf, jmask, capacity)
        for name, arr in fields.items():
            got = buf[name].numpy()
            assert got.shape == (capacity,) + arr.shape[1:]
            np.testing.assert_array_equal(got, np.asarray(want[name]),
                                          err_msg=name)
        np.testing.assert_array_equal(flag.numpy(), np.asarray(want["flag"]))
        assert int(dropped) == int(dropped_j)
    np.testing.assert_array_equal(
        rest.numpy(), valid & ~np.asarray(jup) & ~np.asarray(jdown))
    if case in ("truncated", "capacity-0"):
        assert int(up_t[2]) > 0
    if case == "empty":
        assert int(up_t[1].sum()) == int(down_t[1].sum()) == 0
    if case == "room":
        # The lanes on and beside the edges went the reference's way.
        gids = set(up_t[0]["gid"][up_t[1]].tolist())
        sides = {fields["gid"][lane] in gids for lane in (10, 11, 12)}
        assert sides == {True, False}


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
    edge = torch.tensor(0.5, dtype=torch.float32)
    got = tpack.pack_band_pair(fields, mask, 64, edge, -edge, rest=True)
    want = tpack.pack_band_pair_plain(fields, mask, 64, edge, -edge,
                                      rest=True)
    for (g_buf, g_flag, g_drop), (w_buf, w_flag, w_drop) in zip(got[:2],
                                                                want[:2]):
        for name in fields:
            assert torch.equal(g_buf[name], w_buf[name])
        assert torch.equal(g_flag, w_flag) and torch.equal(g_drop, w_drop)
    assert torch.equal(got[2], want[2])
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


@pytest.mark.parametrize("name", ["pack_band", "pack_indices",
                                  "pack_band_pair"])
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
    edge = torch.tensor(0.5, dtype=torch.float32)
    up, down, rest = tpack.pack_band_pair(fields, mask, 16, edge, None,
                                          up_inclusive=True, rest=True)
    assert up[0]["pos"].shape == down[0]["pos"].shape == (16, 3)
    assert up[1].shape == (16,) and rest.shape == (N,)
    assert len(tpack.pack_band_pair(fields, mask, 16, edge, edge)) == 2
    assert [c[0] for c in calls] == ["pack_band", "pack_band",
                                     "pack_indices", "pack_band_pair",
                                     "pack_band_pair"]
    # valid, pos, n; the up edge given, the down edge null; >=; capacity
    # and fields; rest given, then left out.
    pair = calls[3][1]
    assert pair[2] == N and pair[3].value is not None
    assert pair[4].value is None and pair[5:8] == (1, 16, 5)
    assert pair[-2].value is not None and calls[4][1][-2].value is None
    assert calls[4][1][5] == 0
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
