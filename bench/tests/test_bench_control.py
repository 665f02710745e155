"""The controls at a size a test run holds, on the CPU: the reference in
the program's place one precision down fails the check the sound program
passes (on the card they run at each cell's own size: ``control.py``)."""
import benchkit
import pytest
import torch

import control
from reference import sort as ref

SEEDS = [benchkit.SEED, benchkit.SEED + 1, benchkit.SEED + 2]


@pytest.mark.parametrize("name,number", [("paper_sort-uniform-2p27", "keys_mismatched"),
                                         ("paper_sort-skewed64-argsort-2p27",
                                          "order_mismatched"),
                                         (benchkit.MESH["name"], "keys_mismatched")])
@pytest.mark.parametrize("seed", SEEDS)
def test_sort_control_fails_the_exact_comparison(name, number, seed):
    config, tr, wl = benchkit.pieces(name)
    reading = control._sort(name, config, tr, wl, seed, torch.device("cpu"))
    assert reading[number] > wl["check"]["limits"][number] == 0


def test_the_reference_is_stable_and_exact():
    x = torch.tensor([3, 1, 3, 0, 1], dtype=torch.int32)
    keys, order = ref.sort(x, "order")
    assert keys.tolist() == [0, 1, 1, 3, 3] and order.tolist() == [3, 1, 4, 0, 2]
    assert ref.mismatches(keys, keys.clone()) == 0 and ref.mismatches(None, keys) == 5


@pytest.mark.parametrize("seed", SEEDS)
def test_model_control_separates_from_the_program(seed):
    torch.set_num_threads(4)
    name = "deepseek-moe-16b-prefill-8k"
    config, tr, wl = benchkit.pieces(name)
    dev = torch.device("cpu")
    program = control._lm_readings(config, tr, wl, seed, dev, program=True)
    low = control._lm_readings(config, tr, wl, seed, dev, program=False)
    assert low["logit_err"] >= 3 * program["logit_err"]
    assert low["logit_err"] > wl["check"]["limits"]["logit_err"] > program["logit_err"]
