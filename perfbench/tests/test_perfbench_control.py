"""The correctness control at a size a test run holds: the program's
answers pass the limit, and the two bfloat16 controls (the LP's nonzeros
rounded before the solve; the answer rounded after it) fail it."""

import pytest

from perfbench import control, harness


@pytest.mark.parametrize("workload", ["stair50k.ordered",
                                      "stair50k.shuffled"])
def test_control_fails_where_the_program_passes(workload):
    import importlib

    c = harness.cell(harness.load_json(harness.ROOT, "BENCHMARK.json"),
                     workload)
    c["config"]["generator"].update(n_rows=4096, n_cols=4096)
    drv = importlib.import_module(
        f"perfbench.drivers.{c['config']['driver']}").Driver(
            c["config"], c["traffic"], "cpu")
    limit = c["config"]["check"]["kkt_limit"]
    for row in control.readings(drv, 31, 2):
        assert row["status"] == "Optimal"
        assert row["program"] <= limit
        assert abs(row["program"] - row["own"]) < 0.01
        assert row["matrix"] > 3 * limit
        assert row["answer"] > 3 * limit
