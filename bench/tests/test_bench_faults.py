"""Each fault a cell can have, planted underneath a run on the CPU, makes
``correct`` come out false."""
import benchkit
import faults
import pytest


@pytest.mark.parametrize("cell,fault", [
    ("paper_sort-uniform-2p27", "answer"),
    ("paper_sort-skewed64-argsort-2p27", "answer"),
    ("deepseek-moe-16b-prefill-8k", "token"),
])
def test_a_fault_on_one_card_is_caught(monkeypatch, cell, fault):
    faults.apply(fault, monkeypatch.setattr)
    result, err = benchkit.run_cpu(cell)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values()), err


def test_the_argsort_fault_is_caught_in_the_permutation(monkeypatch):
    faults.apply("answer", monkeypatch.setattr)
    result, _ = benchkit.run_cpu("paper_sort-skewed64-argsort-2p27")
    assert result["checks"]["order_mismatched"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer", "exchange"])
def test_a_fault_across_ranks_is_caught(fault):
    # every rank is a process of its own (rank_cpu.py), each with the fault
    result, err = benchkit.run_cpu(benchkit.MESH["name"], rank_args=("--fault", fault))
    assert result is not None, err[-2000:]
    assert result["correct"] is False and result["checks"]["keys_mismatched"]["value"] > 0


def test_a_sound_run_across_ranks_is_correct():
    result, err = benchkit.run_cpu(benchkit.MESH["name"])
    assert result is not None, err[-2000:]
    assert result["correct"] and result["device"]["count"] == 4


def test_a_rank_holding_jax_refuses_the_run():
    # ranks 1-3 load "jax"; rank 0, which prints the result, does not
    result, err = benchkit.run_cpu(benchkit.MESH["name"], rank_args=("--hold", "jax"))
    assert result is None and "jax" in err
