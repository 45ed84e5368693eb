"""The control: the float64 reference's place taken by the same reference
in float32 with TF32 matrix products on the card (the step below the
configuration's float32), on the pair's and the rodent's envs at a size
a test run holds, judged by the cell's own limits: it comes out not
correct. Needs the card; skips without one."""

import pytest
import torch

from portbench import check, readings
from portbench.tests.tiny import tiny_cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["rodent.flat", "pair.flat"])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, traffic, config = tiny_cell(cell)
    traffic = dict(traffic, num_envs=256, check=dict(env_sample=64, policy_rows=256))
    config = dict(config, batch_size=64)
    for seed in (1, 2, 3):
        r = readings.reading(None, config, traffic, seed, torch.device("cuda", 0), control=True)
        judged = check.judge(r["control"], traffic["limits"])
        assert not all(ok for _, _, ok in judged.values()), judged
