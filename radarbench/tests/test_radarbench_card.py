"""On a card, at the cells' own sizes: the program comes out correct and
its control does not, on three seeds each (the control's readings are
what the limits' upper ends come from; radarbench/control.py prints
them)."""

from __future__ import annotations

import pytest

from radarbench import harness
from radarbench.tests.conftest import make_root, one_card_cells

ONE_CARD = one_card_cells()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_program_correct_and_control_not_at_full_size(card, cell, tmp_path):
    root = make_root(tmp_path / "checkout", tiny=False)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = harness.run_cell(root, cell, seed, 1.0, False, "cuda")
        assert r["correct"], (seed, r["checks"])
        c = harness.run_cell(root, cell, seed, 1.0, False, "cuda", variant="control")
        assert not c["correct"], (seed, c["checks"])
