"""The reference against the port's plain CPU path, at test sizes: every
compared column, counter and CT slot equal on every checked dispatch; and
the control (the reference with the conntrack guarantee broken) put in
the program's place fails the same comparison."""

import pytest

from benchmark.tests.helpers import CELLS, cpu_run

COUNTS = ("rows_mismatched", "ct_slots_mismatched", "counters_mismatched")


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_plain_path_and_the_control_fails(name):
    res, notes = cpu_run(name, control=True)
    checks = res["checks"]
    assert notes["errors"] == []
    assert checks["dispatches_checked"]["value"] >= 3
    for k in COUNTS:
        assert checks[k]["value"] == 0, (k, checks[k])
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert checks["control_rows"]["value"] > 0
    assert checks["control_ct_slots"]["value"] > 0
