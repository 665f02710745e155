"""The port's training path against ``repro`` on the CPU: the loss and its
gradient, the MoE dispatch's gradients, and the train step (micro-batch
accumulation in float32, remat, AdamW) on the smoke configs in float32,
from the same weights (``convert.params_from_jax``) and batches.

Tolerances: the loss and its gradient within 1e-6 x max; the MoE layer's
gradients within 1e-5 x max; the train step's metrics within 1e-5
(relative); AdamW's m and v within 1e-5 x their largest |value| over the
model; the parameters within 1e-5 x the largest |parameter| of the model
plus 1% of the learning rates summed over the steps. The last term is
Adam's: its normalized step turns a gradient near zero, which the two
packages sum in different orders, into a step of up to lr whatever the
gradient's size (an embedding row's net gradient of 1e-7 moves it by
3.3e-4 in both, one step 0.2% larger than the other; 1% is the most seen
on these configs). The optimizer alone, on equal gradients, is held to
1e-6 in tests/test_torch_optim.py. ``repro``'s step is compiled once per
config for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train import loss as jloss
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import attention, moe, transformer
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import loss
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

RNG = np.random.default_rng(29)
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
ACCUM, B, S = 2, 2, 64
STEPS = (1, 2)  # lr(0) == 0: start where the parameters move


def f32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def err(got, want) -> tuple[float, float]:
    got = f32(convert.to_numpy(got) if isinstance(got, torch.Tensor) else got)
    want = f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def close(got, want, rel):
    e, scale = err(got, want)
    assert e <= rel * max(scale, 1e-30), (e, scale)


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_and_its_gradient_match_repro(dtype):
    """Padded vocab columns masked, ignored labels (-1), the z-loss and the
    accuracy; the gradient against ``jax.value_and_grad``."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    vocab, Vp = 500, 512
    logits = (RNG.standard_normal((2, 7, Vp)) * 3).astype(np_dt)
    labels = RNG.integers(0, vocab, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    logits[1, 2, labels[1, 2]] = 40.0  # one certain, right prediction
    (jl, jm), jg = jax.value_and_grad(
        lambda lg: jloss.cross_entropy(lg, jnp.asarray(labels), vocab), has_aux=True)(
        jnp.asarray(logits))
    lt = convert.to_tensor(logits, "cpu").requires_grad_(True)
    tl, tm = loss.cross_entropy(lt, torch.from_numpy(labels), vocab)
    (tg,) = torch.autograd.grad(tl, lt)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert tl.detach().item() == pytest.approx(float(jl), rel=1e-6)
    for k in ("nll", "zloss", "accuracy"):
        assert tm[k].detach().item() == pytest.approx(float(jm[k]), rel=1e-6), k
    assert float(tm["accuracy"]) > 0
    assert tg.dtype == lt.dtype
    close(tg, jg, tol)
    assert float(tg[..., vocab:].abs().max()) == 0.0  # padded columns get nothing


# -------------------------------------------------------- the MoE dispatch


@pytest.mark.parametrize("capacity,use_pallas", [(8.0, False), (0.5, True)])
def test_moe_gradients_match_repro(capacity, use_pallas):
    """The sorted dispatch is differentiable as ``repro``'s: gradients of
    (out^2).mean() + 0.01 aux reach the tokens, the router (through the
    gate weights) and every expert, also where the capacity drops
    assignments (0.5); the sort's keys and slots are integers."""
    jc = dataclasses.replace(jsmoke("deepseek-moe-16b"), dtype="float32",
                             moe_capacity_factor=capacity)
    tc = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32",
                             moe_capacity_factor=capacity)
    d, de, E = jc.d_model, jc.d_expert, jc.n_experts
    shapes = {"router": (d, E), "wi": (E, d, de), "wg": (E, d, de), "wo": (E, de, d)}
    p = {k: (RNG.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
         for k, s in shapes.items()}
    x = RNG.standard_normal((2, 40, d)).astype(np.float32)

    def jl(params, xx):
        o, aux = jmoe.moe_forward(xx, params, jc, None, use_pallas=use_pallas)
        return (o ** 2).mean() + 0.01 * aux

    jgp, jgx = jax.jit(jax.grad(jl, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p),
                                                      jnp.asarray(x))
    layer = moe.MoE(*(torch.from_numpy(p[k]) for k in ("router", "wi", "wg", "wo")))
    xt = torch.from_numpy(x).requires_grad_(True)
    o, aux = moe.moe_forward(xt, layer, tc, use_pallas=use_pallas)
    grads = torch.autograd.grad((o ** 2).mean() + 0.01 * aux, [xt, *layer.parameters()])
    close(grads[0], jgx, 1e-5)
    for k, g in zip(("router", "wi", "wg", "wo"), grads[1:]):
        close(g, jgp[k], 1e-5)
        assert float(g.abs().sum()) > 0, k


# ----------------------------------------------------------- the train step


_REPRO: dict = {}


def _batch(vocab) -> dict:
    rng = np.random.default_rng(41)
    batch = {"tokens": rng.integers(0, vocab, (ACCUM, B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (ACCUM, B, S)).astype(np.int32)}
    batch["labels"][0, 0, :5] = -1
    return batch


def _configs(arch, **kw):
    return (dataclasses.replace(jsmoke(arch), dtype="float32", **kw),
            dataclasses.replace(smoke_config(arch), dtype="float32", **kw))


def _repro_run(arch, **kw):
    """``repro``'s initial parameters and its state after each of STEPS
    (numpy), compiled once per config for the module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REPRO:
        jc, _ = _configs(arch, **kw)
        jm = JModel(jc)
        tcfg = JTrainConfig(opt=JOptConfig(**OPT))
        params, ost = jinit(jm, tcfg, jax.random.key(3))
        first = jax.tree.map(np.asarray, params)
        step = jax.jit(jmake_step(jm, tcfg))
        batch = {k: jnp.asarray(v) for k, v in _batch(jc.vocab).items()}
        out = []
        for s in STEPS:
            params, ost, metrics = step(params, ost, jnp.int32(s), batch)
            out.append(jax.tree.map(np.asarray, (params, ost, metrics)))
        _REPRO[key] = first, out
    return _REPRO[key]


def _port_run(arch, monkeypatch=None, **kw):
    _, tc = _configs(arch, **kw)
    first, _ = _repro_run(arch, **kw)
    model = Model(tc, device="cpu")
    model.load_state_dict(convert.params_from_jax(tc, first))
    tcfg = TrainConfig(opt=OptConfig(**OPT))
    params, ost = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    out = []
    for s in STEPS:
        params, ost, metrics = step(params, ost, s, _batch(tc.vocab))
        out.append(({k: v.detach().clone() for k, v in params.items()},
                    {k: {n: t.clone() for n, t in d.items()} for k, d in ost.items()},
                    {k: float(v) for k, v in metrics.items()}))
    return tc, params, out


def _assert_runs_match(tc, arch, out, **kw):
    _, want = _repro_run(arch, **kw)
    for (tp, ts, tm), (jp, js, jm) in zip(out, want, strict=True):
        assert set(tm) == set(jm)
        for k in jm:
            assert tm[k] == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7), k
        ref = convert.params_from_jax(tc, jp)
        top = max(float(t.abs().max()) for t in ref.values())
        lr_sum = sum(float(m[2]["lr"]) for m in want)
        for n, t in ref.items():
            e, _ = err(tp[n], t.numpy())
            assert e <= 1e-5 * top + 1e-2 * lr_sum, (n, e, top)
        ref_s = convert.opt_state_from_jax(tc, js)
        for kind in ("m", "v"):
            top = max(float(t.abs().max()) for t in ref_s[kind].values())
            for n, t in ref_s[kind].items():
                e, _ = err(ts[kind][n], t.numpy())
                assert e <= 1e-5 * top, (kind, n, e, top)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_train_step_matches_repro(arch, remat, monkeypatch):
    """Two steps at grad_accum 2 (lr warming up): metrics, parameters, and
    AdamW's m and v through ``opt_state_from_jax``. With remat each block
    runs under ``torch.utils.checkpoint`` (its forward again in the
    backward), without it never; the parameters never collect ``.grad``."""
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tc, params, out = _port_run(arch, remat=remat)
    _assert_runs_match(tc, arch, out, remat=remat)
    assert len(calls) == (tc.n_layers * ACCUM * len(STEPS) if remat else 0)
    assert all(p.grad is None for p in params.values())


def test_flash_train_path_matches_repro(monkeypatch):
    """flash_attention=True with FLASH_MIN_SEQ lowered to 64 in both
    packages: the differentiable online-softmax path (``_flash_attn_train``)
    at S = 128 trains as ``repro``'s does."""
    global S
    monkeypatch.setattr(jattn, "FLASH_MIN_SEQ", 64)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    monkeypatch.setattr(__import__(__name__), "S", 128)
    calls = []
    real = attention._flash_attn_train
    monkeypatch.setattr(attention, "_flash_attn_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tc, _, out = _port_run("qwen3-4b", flash_attention=True)
    _assert_runs_match(tc, "qwen3-4b", out, flash_attention=True)
    assert len(calls) == tc.n_layers * ACCUM * len(STEPS)


def test_bf16_step_accumulates_in_float32():
    """bfloat16 parameters: each micro-batch's gradients are taken with
    ``torch.autograd.grad`` and summed in float32 (``.grad`` stays None);
    the two micro-batches' mean equals one step over the whole batch's
    mean loss, within bfloat16's rounding of the update."""
    cfg = smoke_config("qwen3-4b")
    model = Model(cfg, device="cpu", seed=2)
    tcfg = TrainConfig(opt=OptConfig(**OPT))
    params, ost = init_train_state(model, tcfg)
    before = {k: v.detach().clone() for k, v in params.items()}
    _, ost, metrics = make_train_step(model, tcfg)(params, ost, 1, _batch(cfg.vocab))
    assert all(p.grad is None and p.dtype == before[k].dtype for k, p in params.items())
    assert all(ost["m"][k].dtype == torch.float32 for k in params)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert any(not torch.equal(params[k], before[k]) for k in params)
