"""The control on the card: the reference put in the program's place and
computed one precision below what the configuration states (float32 with
TF32 products; the intrinsic dynamic program, which has no product, in
bfloat16) must read not correct against the cell's limits, and beyond the
limits of the numbers named here on every seed.

Marked ``cuda``: it skips without a card.  On the card, at each cell's own
size (a 1M-path cell takes about a minute):

    python3 -m pytest portbench/tests/test_portbench_control.py -q
"""
import pytest
import torch

from portbench import cases, compare, control

pytestmark = pytest.mark.cuda

# The numbers that the control fails on every seed.
FAILS = {"daily_value_1m": ["npv", "intrinsic"], "daily_reprice_1m": ["npv"],
         "daily_value_2k_panels": ["npv", "intrinsic"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(FAILS))
def test_control_reads_not_correct(cuda, cell):
    limits = cases.cell(cell)["limits"]
    recs = control.readings(cell, [], [901, 902, 903], device=cuda)
    for rec in recs:
        assert not compare.judge(rec, limits), rec
        for name in FAILS[cell]:
            assert rec[name] > limits[name], (name, rec)
