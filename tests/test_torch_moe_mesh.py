"""Expert parallelism of the port against ``repro``'s on 8 ranks.

``repro``'s side runs ``moe_forward`` on ``jax.make_mesh((2, 4), ("data",
"model"))`` over 8 virtual host devices, as tests/test_distributed.py
runs it (tests/torch_mesh_reference.py ``moe``); the port's side is 8 gloo
processes on a ``DeviceMesh("cpu", (2, 4))`` (tests/torch_mesh_worker.py
``moe``), each calling ``moe_forward`` on its block of the same seeded
tokens and its slice of the same experts (tests/torch_mesh_cases.py).
Cases: experts over "model" and over ("data", "model"), the 2-D exchange
factored (``hierarchical_a2a``), a capacity factor of 1.25 where tokens
drop, and S = 1 (tokens replicated over "model"). Every token's output
is within rtol = atol = 2e-5 of ``repro``'s, the aux loss too, and the
two sort paths of the port give the same bits."""
import numpy as np
import pytest

import torch_mesh_cases as C
from torch_parity import run_mesh_sides

CASES = C.moe_cases()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_mesh_sides(tmp_path_factory.mktemp("moe_mesh"), C.WORLD, "moe")


@pytest.mark.parametrize("name", list(CASES))
def test_rank_blocks_equal_repro(both, name):
    ref, ranks = both
    want = ref[f"{name}/out"]
    flat = want.reshape(-1, want.shape[-1])
    covered = np.zeros(flat.shape[0], bool)
    for got in ranks:
        pos = got[f"{name}/pos"].reshape(-1)
        covered[pos] = True
        out = got[f"{name}/out/0"]
        np.testing.assert_array_equal(got[f"{name}/out/1"], out)
        np.testing.assert_allclose(out.reshape(-1, flat.shape[1]), flat[pos],
                                   rtol=2e-5, atol=2e-5)
        for use_pallas in (0, 1):
            np.testing.assert_allclose(got[f"{name}/aux/{use_pallas}"], ref[f"{name}/aux"],
                                       rtol=2e-5, atol=2e-5)
    assert covered.all()


def test_blocks_follow_the_partition_spec(both):
    """Batch over "data", sequence over "model" when S divides (16 tokens
    a rank); at S = 1 the 4 ranks of a "model" row hold the same tokens."""
    _, ranks = both
    sizes = {name: [g[f"{name}/pos"].size for g in ranks] for name in CASES}
    assert sizes["ep1d"] == [8] * C.WORLD
    assert sizes["ep2d_s1"] == [2] * C.WORLD
    rows = [ranks[r]["ep2d_s1/pos"] for r in range(4)]
    assert all(np.array_equal(rows[0], r) for r in rows)
