"""The command itself: on a machine with no card it refuses to run; on
the card (`python -m pytest -m gpu perfbench/tests -q`) a short run of
each cell prints a correct result line."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

RUN = [sys.executable, os.path.join(harness.ROOT, "perfbench", "run.py")]
MAN = harness.load_json(harness.ROOT, "BENCHMARK.json")


def test_no_card_no_result(no_cuda):
    r = subprocess.run(RUN + ["--workload", "stair50k.ordered", "--seed",
                              "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert r.returncode == 2
    assert r.stdout == "" and "CUDA" in r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_short_run_on_the_card(cuda, workload):
    r = subprocess.run(RUN + ["--workload", workload, "--seed",
                              str(2**31 + 5), "--seconds", "3", "--trace",
                              "1"], capture_output=True, text=True,
                       timeout=600, cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {
        m["name"] for m in harness.cell(MAN, workload)["per_layer"]}
