"""``copy_back_mib_per_step`` reads the program's counter, and nothing from
a program without it."""

from types import SimpleNamespace

import pytest

from harness import BENCH_DIR, load_module


@pytest.mark.parametrize("counters, value", [
    ({}, None),
    ({"copy_back_bytes_per_step": None}, None),
    ({"copy_back_bytes_per_step": 3 * 2**19}, 1.5),
])
def test_reads_the_counter_or_nothing(counters, value):
    mod = load_module(BENCH_DIR / "metrics" / "copy_back_mib_per_step.py",
                      "copy_back_mib_per_step")
    assert mod.read(SimpleNamespace(sim=SimpleNamespace(**counters))) == value
