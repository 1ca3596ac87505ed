"""K8's plain version -- the temperature pore's per-particle stage of a
step: drift, the six wall cases, the post-wall recapture -- against the JAX
package's drift + ``wall_pass`` + ``pore_recapture``, and K8's and K14's
(the specular pore's pass) interfaces against their C declarations.

The state is made with numpy: the reference's initial pore with its
velocities scaled up so that one drift crosses the walls, plus strays
scattered around the pore, so that every wall case and every recapture
branch takes particles.  The port gets the uniforms JAX draws for the
step's key.  Tolerances: masks, staging mask, hits, errs, recaptures and
which particles the recapture moved exact; state and staged values within
1e-12 relative in float64 and within 8 ulp of each array's magnitude in
float32 (the cone draw goes through cos/sin, which PyTorch and XLA
evaluate with different polynomials, each within a couple of ulp); ledger
within reduction-order rounding of the event count.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu.ops import measure as jmeasure
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu_torch import convert, kernels
from argon_monte_carlo_tpu_torch.engine import WallLedger
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import oob as toob
from argon_monte_carlo_tpu_torch.ops import pore_pass
from argon_monte_carlo_tpu_torch.state import Measurements as TMeasurements

TARGET = 6000
STRAYS = 600
GAP = 200
SPEEDUP = 60.0
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
CASES = ("1 open-air side", "2 bottom cap", "2 top cap", "3 cold face",
         "3 hot face", "4 gap side", "5 gap bottom", "5 gap top",
         "6 hot side", "6 cold side")


def configs(dtype):
    jc = amc.temperature_pore_config(
        engine=JEngine(dtype=dtype)).scaled_to(TARGET)
    tc = amt.temperature_pore_config(
        engine=amt.EngineConfig(dtype=dtype)).scaled_to(TARGET)
    return jc, tc


def make_state(jc, np_dtype):
    """The reference's initial pore, velocities x SPEEDUP, then strays
    uniform over a box 1.3x the pore's radius and 1.2x its height,
    particles in the gap's annulus beyond the pore radius (case 5's
    source), and two particles that leave the pore through a z cap and
    cross the pore wall at the start of the step, so that the cap's mirror
    image lands in a case-6 band and the back-trace to the wall ends
    beyond the cap (the recapture's z branches); paths, has_collided and a
    few staged events random."""
    jwl = amc.make_workload(jc)
    init = jwl.init_fn(jax.random.PRNGKey(11))
    g = jc.geometry
    ar = jc.physics.argon_radius
    rng = np.random.default_rng(11)
    r = 1.3 * g.open_air_radius * np.sqrt(rng.uniform(size=STRAYS))
    th = rng.uniform(0, 2 * np.pi, STRAYS)
    z = rng.uniform(-0.1, 1.1, STRAYS) * g.total_height
    strays = np.stack([r * np.cos(th), r * np.sin(th), z], 1)
    r = rng.uniform(g.pore_collision_radius(jc.physics),
                    g.gap_collision_radius(jc.physics), GAP)
    th = rng.uniform(0, 2 * np.pi, GAP)
    z = rng.uniform(g.gap_bottom + ar, g.gap_top - ar, GAP)
    gap = np.stack([r * np.cos(th), r * np.sin(th), z], 1)
    cr_pore = g.pore_collision_radius(jc.physics)
    h, oah, dt = g.total_height, g.open_air_height, jc.dt
    caps = np.array([[cr_pore * (1 - 1e-5), 0.0, 0.01 * oah],
                     [cr_pore * (1 - 1e-5), 0.0, h - 0.01 * oah]])
    pos = np.concatenate([np.asarray(init.pos, np.float64), strays, gap,
                          caps])
    n = pos.shape[0]
    vel = rng.normal(0.0, jc.physics.a_shape, (n, 3)) * SPEEDUP
    vel[-2:] = [[0.5 * ar / dt, 0.0, -1.2 * oah / dt],
                [0.5 * ar / dt, 0.0, 1.2 * oah / dt]]
    return n, {
        "pos": pos.astype(np_dtype),
        "vel": vel.astype(np_dtype),
        "paths": rng.uniform(0, 2e-7, (n, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=n) < 0.6,
    }, {
        "pending_vals": rng.uniform(0, 1e-6, (n, 4)).astype(np_dtype),
        "pending_mask": rng.uniform(size=n) < 0.05,
    }


def reference_advance(jc, arrays, staging, key):
    """The JAX package's drift (engine.py:153-156), wall pass and post-wall
    recapture, and which particles the recapture moved."""
    jwl = amc.make_workload(jc)
    state = amc.state.ParticleState(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    n = arrays["pos"].shape[0]
    meas = JMeasurements.zeros(200, arrays["pos"].dtype, num_particles=n)
    meas = dataclasses.replace(meas, **{k: jnp.asarray(v)
                                        for k, v in staging.items()})
    prior = state.pos
    state.paths = jmeasure.accumulate_drift(state, jc.dt)
    state.pos = state.pos + jc.dt * state.vel
    state, meas, ledger = jwl.wall_pass(state, prior, meas, key)
    pre = state.pos
    state, recaptured = jwl.post_wall(state)
    recap_w = jnp.any(state.pos != pre, axis=-1)
    return state, meas, ledger, recaptured, recap_w


def port_inputs(arrays, staging, t_dtype):
    state, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    meas = TMeasurements.zeros(200, t_dtype, num_particles=len(
        arrays["pos"]))
    meas = dataclasses.replace(
        meas, pending_vals=torch.from_numpy(staging["pending_vals"]),
        pending_mask=torch.from_numpy(staging["pending_mask"]))
    return state, meas


def recapture_branches(state, geom) -> list:
    """How many particles each of pore_recapture's five branches takes."""
    x, y, z = (state.pos[:, k].double().numpy() for k in range(3))
    h, oah = geom.total_height, geom.open_air_height
    m1, m2 = z < 0.0, z > h
    z = np.where(m1, 0.5 * oah, np.where(m2, h - 0.5 * oah, z))
    r2 = x * x + y * y
    m3 = r2 > geom.open_air_radius**2
    r2 = np.where(m3, 0.0, r2)
    m4 = (r2 > geom.gap_radius**2) & (z > oah) & (z < h - oah)
    r2 = np.where(m4, 0.0, r2)
    coated = ((z > oah) & (z < geom.gap_bottom)) | (
        (z > geom.gap_top) & (z < h - oah))
    m5 = (r2 > geom.pore_coated_radius**2) & coated
    return [int(m.sum()) for m in (m1, m2, m3, m4, m5)]


def assert_floats(actual, expected, np_dtype, ulps=8):
    actual, expected = np.asarray(actual), np.asarray(expected)
    eps = ulps * np.finfo(np.float32).eps if np_dtype == np.float32 else 1e-12
    np.testing.assert_allclose(actual, expected, rtol=eps,
                               atol=eps * np.abs(expected).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_advance_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    n, arrays, staging = make_state(jc, np_dtype)
    key = jax.random.PRNGKey(5)
    uniforms = torch.from_numpy(np.array(
        jax.random.uniform(key, (n, 2), np_dtype)))
    js, jm, jl, jrec, jrw = reference_advance(jc, arrays, staging, key)

    twl = amt.make_workload(tc)
    state, meas = port_inputs(arrays, staging, t_dtype)
    cases = {}
    ts, tm, tl, trec, trw, tsp = twl.advance_plain(state, meas, uniforms,
                                                   cases)
    assert tuple(cases) == CASES
    took = {name: int(m.sum()) for name, m in cases.items()}
    assert min(took.values()) > 0, took

    # Every recapture branch takes particles (counted on the state the
    # walls left, which the plain advance recaptures).
    walled = tc.geometry
    prior = state.pos
    drifted = dataclasses.replace(
        state, paths=tmeasure.accumulate_drift(state, tc.dt),
        pos=state.pos + tc.dt * state.vel)
    after_walls, _, _ = twl.wall_pass(drifted, prior, meas, uniforms)
    branches = recapture_branches(after_walls, walled)
    assert min(branches) > 0, branches
    assert int(trec) == int(jrec) == sum(branches)

    assert int(tl.wall_hits) == int(jl.wall_hits) > 100
    assert int(tl.errs) == int(jl.errs) > 0
    np.testing.assert_array_equal(trw.numpy(), np.asarray(jrw))
    np.testing.assert_array_equal(ts.has_collided.numpy(),
                                  np.asarray(js.has_collided))
    np.testing.assert_array_equal(tm.pending_mask.numpy(),
                                  np.asarray(jm.pending_mask))
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(ts, f).numpy(), getattr(js, f), np_dtype)
    assert_floats(tm.pending_vals.numpy(), jm.pending_vals, np_dtype)
    np.testing.assert_array_equal(
        tsp.numpy(), tmeasure.speed(state.vel).numpy())
    hits = int(tl.wall_hits)
    for f in ("momentum_z", "energy_hot", "energy_cold"):
        a, b = float(getattr(tl, f)), float(getattr(jl, f))
        assert a == pytest.approx(b, rel=hits * np.finfo(np_dtype).eps * 8,
                                  abs=1e-30), f


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_advance_equals_unfused_sequence(dtype):
    """The workload's advance on the CPU is the engine's old unfused
    sequence, bitwise: speed, drift, wall pass, recapture."""
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    n, arrays, staging = make_state(jc, np_dtype)
    uniforms = torch.from_numpy(
        np.random.default_rng(3).uniform(size=(n, 2)).astype(np_dtype))
    wl = amt.make_workload(tc)
    state, meas = port_inputs(arrays, staging, t_dtype)

    speed_pre = tmeasure.speed(state.vel)
    prior = state.pos
    s = dataclasses.replace(state,
                            paths=tmeasure.accumulate_drift(state, tc.dt),
                            pos=state.pos + tc.dt * state.vel)
    s, m, ledger = wl.wall_pass(s, prior, meas, uniforms)
    pre = s.pos
    s, recaptured = toob.pore_recapture(s, tc.geometry,
                                        0.5 * tc.geometry.open_air_height)
    recap_w = torch.any(s.pos != pre, dim=-1)

    before = sum(kernels.launch_counts.values())
    got = wl.advance(state, meas, uniforms)
    assert sum(kernels.launch_counts.values()) == before
    want = (s, m, ledger, recaptured, recap_w, speed_pre)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(a, WallLedger):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name))


# Each per-particle kernel: its source, the file of its ``enum Param`` and
# the names of its constants in the wrapper's order.
PASSES = {
    "pore_advance": ("pore_walls.cu", "pore_recapture.cuh",
                     pore_pass.PARAM_NAMES),
    "specular_advance": ("specular_walls.cu", "specular_walls.cu",
                         pore_pass.SPECULAR_PARAM_NAMES),
}


@pytest.mark.parametrize("kernel", sorted(PASSES))
def test_kernel_interface_matches_source(kernel):
    """amc_pore_advance's (K8's) and amc_specular_advance's (K14's) ctypes
    tables equal their C declarations (stream last), and the constants'
    names equal ``enum Param``'s, in order (K8's in the header it shares
    with K13; both kernels include it, for the recapture's radial
    checks)."""
    source, enum_file, param_names = PASSES[kernel]
    src = (kernels.CSRC / source).read_text()
    header = (kernels.CSRC / enum_file).read_text()
    assert '#include "pore_recapture.cuh"' in src
    (params,) = re.findall(rf"AMC_EXPORT int amc_{kernel}\((.*?)\)\s*\{{",
                           src, re.S)
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    kinds = ["P" if "*" in p or "cudaStream_t" in p
             else "F" if p.split()[0] == "float" else "I"
             for p in params.split(",")]
    assert [types[k] for k in kinds] == kernels._SIGNATURES[kernel]
    (enum,) = re.findall(r"enum Param \{(.*?)\};", header, re.S)
    names = [e.strip() for e in enum.split(",")]
    want = ["k" + "".join(w.capitalize() for w in p.split("_"))
            for p in param_names] + ["kNumParams"]
    assert names == want


def wrapper_case(kernel):
    """(workload, state, staging, constants the plain version computes by
    name) of K8's or K14's pore in float32."""
    if kernel == "pore_advance":
        jc, tc = configs("float32")
        n, arrays, staging = make_state(jc, np.float32)
        state, meas = port_inputs(arrays, staging, torch.float32)
        g, phys = tc.geometry, tc.physics
        return amt.make_workload(tc), state, meas, {
            "dt": tc.dt, "h": g.total_height,
            "plane_cold": (g.total_height - g.open_air_height
                           + phys.argon_radius),
            "half_mass": 0.5 * phys.mass,
            "cr_pore_sq": g.pore_collision_radius(phys)**2,
            "h_m_z_inset": g.total_height - 0.5 * g.open_air_height}
    tc = amt.PoreConfig(engine=amt.EngineConfig(dtype="float32")).scaled_to(
        TARGET)
    wl = amt.make_workload(tc)
    state = wl.init_fn(torch.Generator().manual_seed(11), "cpu")
    meas = TMeasurements.zeros(200, torch.float32,
                               num_particles=state.num_particles)
    g, phys = tc.geometry, tc.physics
    cr_oa = g.open_air_collision_radius(phys)
    return wl, state, meas, {
        "dt": tc.dt, "cr_oa_rr": cr_oa * cr_oa,
        "h_m_oah": g.total_height - g.open_air_height,
        "gap_side_top": (g.total_height - g.open_air_height
                         - g.cold_coating_height),
        "nudge": 10.0 * phys.argon_radius,
        "rc_sq": g.pore_coated_radius**2}


@pytest.mark.parametrize("kernel", sorted(PASSES))
def test_wrapper_passes_declared_arguments(kernel, monkeypatch):
    """The wrapper (K8's, K14's), forced down its kernel side with the
    launch intercepted, passes the declared argument kinds and the
    constants in the order of their names, each a float32 of the plain
    version's double."""
    calls = []

    def fake_launch(name, device, *args):
        sig = kernels._SIGNATURES[name][:-1]
        assert len(args) == len(sig)
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (arg, kind)
        calls.append(name)

    wl, state, meas, expect = wrapper_case(kernel)
    n = state.num_particles
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    out = wl.advance(state, meas, torch.zeros((n, 2)))
    assert calls == [kernel] and len(out) == 6
    assert out[0] is state and out[1] is meas
    with pytest.raises(TypeError):
        wl.advance(dataclasses.replace(state, pos=state.pos.double()), meas,
                   torch.zeros((n, 2)))

    prm = next(c.cell_contents for c in wl.advance.__closure__
               if isinstance(c.cell_contents, (pore_pass.PoreParams,
                                               pore_pass.SpecularParams)))
    values = prm.on(torch.device("cpu"))
    if kernel == "pore_advance":
        values, horner = values
        assert horner.dtype == torch.float32 and horner.numel() == 13
    names = PASSES[kernel][2]
    assert values.dtype == torch.float32 and values.numel() == len(names)
    for name, value in expect.items():
        got = values[names.index(name)]
        assert got == torch.tensor(value, dtype=torch.float32), name
