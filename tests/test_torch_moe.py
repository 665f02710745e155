"""The port's MoE dispatch against ``repro``'s on the CPU.

The smoke deepseek-moe-16b config in float32 at moe_capacity_factor 8.0,
as tests/test_moe.py runs it, with ``repro``'s weights
(``init_moe(jax.random.key(1))``) carried across as tensors and the same
seeded numpy tokens. ``stable_argsort``, the router's expert ids and the
dispatch's send counts are compared exactly; outputs within rtol = atol =
2e-5 (the two differ only in the order of accumulation). ``repro``'s
Pallas paths run in interpret mode; the port's run the kernels' twins."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.core import keyenc as jkeyenc
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.core import keyenc
from repro_torch.models import moe


@pytest.fixture(autouse=True)
def _no_grad():
    """Parameters require grad (the port trains): every case here compares
    forward passes, so it runs under ``torch.no_grad()``, as serving does."""
    with torch.no_grad():
        yield


NAMES = ("router", "wi", "wg", "wo")
TOL = dict(rtol=2e-5, atol=2e-5)


def cfgs(**kw):
    kw = {"moe_capacity_factor": 8.0, "dtype": "float32", **kw}
    return (dataclasses.replace(jsmoke("deepseek-moe-16b"), **kw),
            dataclasses.replace(smoke_config("deepseek-moe-16b"), **kw))


def port_moe(p, lo=0, hi=None) -> moe.MoE:
    """``repro``'s MoE params (experts [lo, hi)) as the port's module."""
    t = {n: convert.to_tensor(np.asarray(p[n]), "cpu") for n in NAMES}
    return moe.MoE(t["router"], *(t[n][lo:hi] for n in NAMES[1:]))


@pytest.fixture(scope="module")
def setup():
    jc, tc = cfgs()
    p = jmoe.init_moe(jax.random.key(1), jc, None)
    x = np.random.default_rng(2).standard_normal((2, 32, jc.d_model)).astype(np.float32)
    return jc, tc, p, port_moe(p), x


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,distinct", [(1, 8), (128, 8), (3000, 64), (4096, 2)])
def test_stable_argsort_matches_repro(n, distinct, use_pallas):
    keys = np.random.default_rng(n).integers(0, distinct, n).astype(np.int32)
    jk, jo = jkeyenc.stable_argsort(jnp.asarray(keys), use_pallas=use_pallas)
    tk, to = keyenc.stable_argsort(torch.from_numpy(keys), use_pallas=use_pallas)
    assert tk.dtype == torch.int32 and to.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("tied", [False, True])
def test_router_matches_repro(setup, tied):
    """Ids exactly, weights and aux within 1e-6; with two identical router
    columns both pick the lower expert index of each tie, as ``lax.top_k``."""
    jc, tc, p, m, x = setup
    router = np.asarray(p["router"]).copy()
    if tied:
        router[:, 5] = router[:, 2]
    xf = x.reshape(-1, jc.d_model)
    jw, jids, jaux = jmoe._router(jnp.asarray(xf), jnp.asarray(router), jc)
    w, ids, aux = moe._router(torch.from_numpy(xf), torch.from_numpy(router), tc)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if tied:
        both = (np.asarray(jids) == 2) | (np.asarray(jids) == 5)
        assert both.any()


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n_shards,shard_id", [(1, 0), (2, 0), (2, 1), (4, 0), (4, 3)])
def test_dispatch_body_matches_repro(setup, n_shards, shard_id, use_pallas):
    """One rank's six steps with the exchange left out (each bucket comes
    back to its sender), on that shard's experts: send counts exactly,
    output and aux within the tolerance."""
    jc, tc, p, _, x = setup
    e_loc = jc.n_experts // n_shards
    lo, hi = shard_id * e_loc, (shard_id + 1) * e_loc
    jp = {n: p[n] if n == "router" else p[n][lo:hi] for n in NAMES}
    xf = x.reshape(-1, jc.d_model)
    jout, jaux, jsend = jmoe._dispatch_body(jnp.asarray(xf), jp, jc, n_shards=n_shards,
                                            shard_id=jnp.int32(shard_id), a2a=lambda t: t,
                                            use_pallas=use_pallas)
    out, aux, send = moe._dispatch_body(torch.from_numpy(xf), port_moe(p, lo, hi), tc,
                                        n_shards=n_shards, shard_id=shard_id,
                                        a2a=lambda t: t, use_pallas=use_pallas)
    assert send.dtype == torch.int32
    np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
    assert int(send.sum()) == xf.shape[0] * jc.moe_topk
    close(out.numpy(), jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_forward_and_ref_match_repro(setup, use_pallas):
    jc, tc, p, m, x = setup
    jout, jaux = jmoe.moe_forward(jnp.asarray(x), p, jc, None, use_pallas=use_pallas)
    out, aux = moe.moe_forward(torch.from_numpy(x), m, tc, use_pallas=use_pallas)
    close(out.numpy(), jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    jref, _ = jmoe.moe_ref(jnp.asarray(x), p, jc)
    ref, _ = moe.moe_ref(torch.from_numpy(x), m, tc)
    close(ref.numpy(), jref)
    close(out.numpy(), jref)  # nothing drops at capacity factor 8


@pytest.mark.parametrize("S", [1, 5])
def test_moe_forward_decode_matches_repro(setup, S):
    jc, tc, p, m, x = setup
    jout, jaux = jmoe.moe_forward_decode(jnp.asarray(x[:, :S]), p, jc, None)
    out, aux = moe.moe_forward_decode(torch.from_numpy(x[:, :S]), m, tc)
    close(out.numpy(), jout)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dropped_tokens_match_repro(setup, cf):
    """A tight capacity drops tokens; the port drops the same ones."""
    jc, tc, p, m, x = setup
    jt, tt = (dataclasses.replace(c, moe_capacity_factor=cf) for c in (jc, tc))
    jout, _ = jmoe.moe_forward(jnp.asarray(x), p, jt, None)
    outs = [moe.moe_forward(torch.from_numpy(x), m, tt, use_pallas=u)[0] for u in (False, True)]
    close(outs[0].numpy(), jout)
    assert torch.equal(outs[0], outs[1])
    ref, _ = moe.moe_ref(torch.from_numpy(x), m, tc)
    if cf == 0.5:
        assert float((outs[0] - ref).abs().max()) > 0.1  # some tokens did drop


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_sort_paths_give_equal_bits(setup, dtype):
    jc, tc, p, m, x = setup
    tc = dataclasses.replace(tc, dtype=dtype)
    if dtype == "bfloat16":
        m = moe.MoE(m.router, *(t.to(torch.bfloat16) for t in (m.wi, m.wg, m.wo)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    a, aux_a = moe.moe_forward(xt, m, tc, use_pallas=True)
    b, aux_b = moe.moe_forward(xt, m, tc, use_pallas=False)
    assert a.dtype == xt.dtype and torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_bf16_forward_matches_repro(setup):
    jc, tc, p, m, x = setup
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    jp = {n: p[n] if n == "router" else p[n].astype(jnp.bfloat16) for n in NAMES}
    m = moe.MoE(m.router, *(t.to(torch.bfloat16) for t in (m.wi, m.wg, m.wo)))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jout, _ = jmoe.moe_forward(xb, jp, jc, None)
    out, _ = moe.moe_forward(convert.to_tensor(np.asarray(xb), "cpu"), m, tc)
    want = np.asarray(jout).astype(np.float32)
    assert float(np.abs(out.float().numpy() - want).max()) <= 5e-2 * np.abs(want).max()


def test_a_mesh_call_needs_the_ranks_experts(setup, monkeypatch):
    """On a mesh of more than one expert shard ``moe_forward`` takes this
    rank's experts (``shard_params``); the full set raises."""
    from repro_torch.sharding.spec import Axes

    jc, tc, p, m, x = setup

    class Group:
        size, index = 2, 1

    axes = Axes(mesh_shape={"data": 1, "model": 2}, mesh=object())
    assert axes.expert_size == 2
    monkeypatch.setattr(moe, "axis_group", lambda mesh, axis: Group())
    with pytest.raises(ValueError, match="shard_params"):
        moe.moe_forward(torch.from_numpy(x), m, tc, axes)
    local = moe.shard_params(m, axes)
    half = jc.n_experts // 2
    assert torch.equal(local.wi, m.wi[half:]) and torch.equal(local.wo, m.wo[half:])
    assert local.router.data_ptr() == m.router.data_ptr()
