"""The control, the reference computed in TF32 and put in the program's
place, fails the cells' limits at a size a test run holds: the CPU has no
TF32, so the reference rounds its products' operands to TF32 there.  On
the card the control runs at the cells' own sizes through
``perfbench/tools/calibrate.py``; ``test_control_on_the_card`` runs it
there."""
import subprocess
import sys

import pytest

from perfbench.common import harness
from perfbench.tests import smoke


@pytest.mark.parametrize("name", ["caps-smoke.batch", "caps-smoke.train"])
def test_the_control_fails_where_the_program_passes(smoke_base, name):
    line, ctx, out = smoke.run_cell(smoke_base, name, seconds=0.5,
                                    control=True)
    assert line["correct"]
    assert ctx.control_checks
    assert not all(c.ok for c in ctx.control_checks), ctx.control_checks


@pytest.mark.card
@pytest.mark.parametrize("name", ["caps-mn1.batch", "caps-en3.batch",
                                  "caps-mn1.train"])
def test_control_on_the_card(card, name):
    r = subprocess.run(
        [sys.executable, "perfbench/tools/calibrate.py", "--workload", name,
         "--seeds", "11,12,13", "--seconds", "2"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(rows) == 3
    limits = harness.load_json(harness.BASE / "workloads" /
                               f"{name}.json")["limits"]
    for row in rows:
        assert row["correct"]
        assert any(v > limits[k] for k, v in row["control"].items())
