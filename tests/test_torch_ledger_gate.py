"""The ledger gate's own pieces on the CPU: ``chip_smoke.py`` reads the JAX
package's 250-step ledger (``parity_momentum_energy.csv``, written by
``scripts/parity_run.py``) as pandas reads it there, and its copy of the
reference's z-test (``scripts/parity_run.py:69-79``) gives that script's
numbers and verdicts.  The gate itself runs on the card, at the reference
scale (``chip_smoke.check_ledger_gate``)."""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CSV = ROOT / chip_smoke.LEDGER_CSV


def parity_run_verdict(r, o):
    """scripts/parity_run.py:69-79, as written there."""
    mean_r, mean_o = r.mean(), o.mean()
    std_r, std_o = r.std(), o.std()
    se = np.sqrt(std_r**2 / len(r) + std_o**2 / len(o))
    z = abs(mean_o - mean_r) / se if se > 0 else np.inf
    ok = z < 4.0 and 0.5 < (std_o / std_r) < 2.0
    return z, std_o / std_r, ok


def test_ledger_csv_reads_as_pandas():
    """Exactly as pandas' round-trip parser reads it (Python's float() is
    correctly rounded; pandas' default parser is within an ulp)."""
    got = chip_smoke.read_ledger_csv(CSV)
    ref = pd.read_csv(CSV, index_col=0, float_precision="round_trip")
    assert len(ref) == chip_smoke.LEDGER_STEPS
    for col, _ in chip_smoke.LEDGER_COLUMNS:
        np.testing.assert_array_equal(got[col], ref[col].to_numpy())


@pytest.mark.parametrize("case", ["itself", "noise", "shifted", "wide",
                                  "narrow"])
def test_ledger_z_test_matches_parity_run(case):
    """Series around the reference's EnergyCold column: itself, redrawn
    noise of the same spread (passes), shifted by six standard errors,
    spread 2.5x and 0.3x (fail)."""
    r = chip_smoke.read_ledger_csv(CSV)["EnergyCold"]
    rng = np.random.default_rng(3)
    noise = rng.normal(0.0, r.std(), r.shape[0])
    se = r.std() * np.sqrt(2.0 / r.shape[0])
    o = {"itself": r, "noise": r.mean() + noise,
         "shifted": r + 6 * se, "wide": r.mean() + 2.5 * noise,
         "narrow": r.mean() + 0.3 * noise}[case]
    z, ratio, ok = chip_smoke.ledger_z_test(r, o)
    z_ref, ratio_ref, ok_ref = parity_run_verdict(r, o)
    assert z == pytest.approx(z_ref, rel=1e-12, abs=1e-12)
    assert ratio == pytest.approx(ratio_ref, rel=1e-12)
    assert ok == ok_ref == (case in ("itself", "noise"))
