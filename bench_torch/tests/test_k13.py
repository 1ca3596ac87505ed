"""K13's yardstick: the job's bytes (``counts/k13.py``) as chip_smoke.py
bounds them, and ``k13_roofline_pct`` silent where the kernel never ran."""

from types import SimpleNamespace

import chip_smoke
from counts import k13
from harness import BENCH_DIR, load_module


def traced(calls, seconds, n=999_999):
    return SimpleNamespace(
        calls={"Simulation._step": calls} if calls else {},
        device_s=lambda **kw: seconds,
        state=SimpleNamespace(num_particles=n))


def test_bytes_and_bound_are_chip_smokes():
    n = 999_999
    assert k13.bytes_moved(n) == 34_999_965
    want = chip_smoke.result(0.0, 1.0, 1.0, 35 * n)
    assert k13.bound_ms(n) == (want["bound_ms"], want["bound_by"])


def test_roofline_reads_none_without_the_kernel():
    mod = load_module(BENCH_DIR / "metrics" / "k13_roofline_pct.py", "k13m")
    assert mod.read(traced(200, 0.0)) is None
    assert mod.read(traced(0, 0.0)) is None
    ms, _ = k13.bound_ms(999_999)
    # 200 steps of twice the bound each: 50%.
    assert abs(mod.read(traced(200, 200 * 2 * ms / 1e3)) - 50.0) < 1e-9
