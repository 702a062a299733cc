"""The control on the card: the reference computed with TF32 on (one
precision below the configuration's float32 with TF32 off), put in the
program's place, has to fail the cell's comparison, at the cell's own
size.  ``slambench/tools/control.py`` runs the same over more seeds."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", WORKLOADS)
def test_the_control_is_not_correct(card, name):
    from slambench.cell import load_cell, load_json
    from slambench.tools.control import control

    cell = load_cell(ROOT, load_json(ROOT / "BENCHMARK.json"), name)
    rec = control(cell, 2**31 + 31, card)
    assert rec["fails"], rec
