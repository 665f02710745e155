"""``repro_torch.sort`` against ``repro.sort`` on the sim backend, for
every admitted key dtype, with the kernels on (``use_pallas=True``, as
repro runs by default: Pallas in interpret mode there, the plain twins
here) and off. Exact equality of every output field."""
import numpy as np
import pytest

import repro
from torch_parity import DTYPES, assert_sort_equal, make_keys, sort_both

RNG = np.random.default_rng(5)


def _pallas(use_pallas: bool):
    return dict(config=repro.SortConfig(tile=128, use_pallas=use_pallas),
                limits=repro.SortLimits(n_procs=4))


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_pallas(dtype):
    keys = make_keys(RNG, 600, dtype)
    for kw in [dict(), dict(order="desc"), dict(order="desc", want="order")]:
        assert_sort_equal(*sort_both(keys, **_pallas(True), **kw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_plain(dtype):
    keys = make_keys(RNG, 1000, dtype)
    vals = make_keys(RNG, 1000, "int32")
    for kw in [dict(), dict(order="desc"), dict(want="order"),
               dict(values=vals, order="desc")]:
        assert_sort_equal(*sort_both(keys, **_pallas(False), **kw))
