"""The harness driven end to end on the CPU (``device="cpu"``: the port runs
its kernels' plain versions), for every cell of ``BENCHMARK.json`` at the
sizes its traffic file gives under ``test``: each cell comes out correct,
with and without the trace; with each fault of its driver
(``tests/faults/<driver>.py``) planted in the timed path, or with the
control (the plain reference in bfloat16, at the sizes under
``control_test``) in the program's place, it does not."""

import json
from pathlib import Path

import pytest

from benchmark import harness, judge
from benchmark.readings import readings

pytest.importorskip("ldpc_tpu_torch")

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 11


def _traffic(cell):
    return harness.Cell(cell).traffic


def _faults(cell):
    path = ROOT / "benchmark" / "tests" / "faults" / f"{_traffic(cell)['driver']}.py"
    return harness.load_module(path).FAULTS


def _run(cell, trace=False, hook=None):
    return harness.run(cell, SEED, 0.5, trace, device="cpu", traffic=_traffic(cell)["test"],
                       driver_hook=hook)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_cpu(cell, trace):
    out = _run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        assert out["window"]["slice"]["calls"] == _traffic(cell)["test"]["trace_calls"]
        assert list(out)[-2] == "program"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in sorted(_faults(c))])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    hook = _faults(cell)[fault](monkeypatch)
    assert not _run(cell, hook=hook)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    sizes = dict(_traffic(cell)["control_test"])
    seconds = sizes.pop("seconds")
    r = readings(cell, SEED, seconds, device="cpu", traffic=sizes)
    limits = harness.Cell(cell).limits
    assert judge.verdict(r["program"], limits)[0], r
    assert not judge.verdict(r["control"], limits)[0], r
