"""The traffic generator against the paper's formulas (PGX.D Fig. 4)."""
import benchkit
import pytest
import torch

from benchlib import stats, traffic

N = 1 << 16


def _keys(dist, dtype="float32", seed=benchkit.SEED):
    gen = traffic.generator(seed, "cpu", "test", dist)
    return traffic.keys(dist, N, dtype, gen, "cpu")


def test_uniform_in_the_unit_interval():
    x = _keys("uniform")
    assert x.dtype == torch.float32 and 0 <= x.min() and x.max() < 1
    assert abs(float(x.mean()) - 0.5) < 0.01


def test_right_skewed_is_floor_u6_times_64():
    x = _keys("right_skewed", "int32")
    assert x.dtype == torch.int32 and int(x.min()) == 0 and int(x.max()) <= 63
    # P(floor(64 u^6) = 0) = P(u < 64^(-1/6)) = 1/2; P(>= 32) = 1 - 2^(-1/6)
    assert abs(float((x == 0).float().mean()) - 0.5) < 0.01
    assert abs(float((x >= 32).float().mean()) - (1 - 2 ** (-1 / 6))) < 0.01


def test_exponential_is_floor_of_8_exp1():
    x = _keys("exponential", "int32")
    # P(floor(8 E) = 0) = 1 - e^(-1/8)
    assert abs(float((x == 0).float().mean()) - (1 - torch.exp(torch.tensor(-0.125)))) < 0.01


def test_normal_moments():
    x = _keys("normal")
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 1) < 0.02


def test_unknown_distribution_is_refused():
    with pytest.raises(KeyError):
        _keys("zipf")


def test_a_seed_gives_the_same_inputs_and_another_seed_others():
    tr = {"distribution": "uniform", "dtype": "float32"}
    a = traffic.sort_input(tr, N, benchkit.SEED, 1, 0, "cpu")
    assert torch.equal(a, traffic.sort_input(tr, N, benchkit.SEED, 1, 0, "cpu"))
    assert not torch.equal(a, traffic.sort_input(tr, N, benchkit.SEED + 1, 1, 0, "cpu"))
    assert not torch.equal(a, traffic.sort_input(tr, N, benchkit.SEED, 2, 0, "cpu"))
    assert not torch.equal(a, traffic.sort_input(tr, N, benchkit.SEED, 1, 1, "cpu"))


def test_prompts_cover_the_vocabulary_and_repeat_by_seed():
    tr = {"pool": 3, "batch": 2, "prompt_tokens": 512}
    p = traffic.prompts(tr, 1000, 2**40 + 1, "cpu")
    assert p.shape == (3, 2, 512) and int(p.min()) >= 0 and int(p.max()) < 1000
    assert torch.equal(p, traffic.prompts(tr, 1000, 2**40 + 1, "cpu"))


def test_derived_seeds_are_stable_and_distinct():
    assert stats.derive(5, "a", 1) == stats.derive(5, "a", 1)
    assert len({stats.derive(5, "a", i) for i in range(100)}) == 100
    assert 0 <= stats.derive(2**62, "x") < 2**63


def test_only_one_client_in_a_closed_loop_is_driven():
    traffic.check_loop({"loop": "closed", "clients": 1})
    for bad in ({"loop": "open", "clients": 1}, {"loop": "closed", "clients": 4}, {}):
        with pytest.raises(ValueError):
            traffic.check_loop(bad)
