"""Each cell once on the card, briefly, from a fresh process: it prints a
result line that is correct. Runs on the card only."""

import json
import subprocess
import sys

import pytest

from small import ROOT, bench


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
