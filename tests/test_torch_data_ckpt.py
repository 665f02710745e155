"""The port's data pipeline, checkpoints and fault-tolerance manager:
the counterparts of tests/test_data_checkpoint.py, each held to ``repro``
on the CPU where it computes something. Length orders and packed batches
are equal bit for bit (sim and stream); checkpoints round-trip bit for
bit, and a step taken right after ``save_async`` does not reach the
checkpoint (the port updates its state in place)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data import pipeline as jpipe
from repro.ft import manager as jft
from repro_torch import convert
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.registry import smoke_config
from repro_torch.data import pipeline
from repro_torch.data.pipeline import DataConfig, PackedLoader, bucket_by_length
from repro_torch.ft.manager import RestartManager, Watchdog
from repro_torch.models.model import Model
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


def both_loaders(model_cfg=None, **kw):
    jcfg, tcfg = jpipe.DataConfig(**kw), DataConfig(**kw)
    return (iter(jpipe.PackedLoader(jcfg, model_cfg)),
            iter(PackedLoader(tcfg, model_cfg, device="cpu")))


def assert_batches_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("n,threshold", [(300, None), (3000, 1024)])
def test_bucket_by_length_matches_repro(n, threshold):
    """The stable length order: 300 lengths in one sim sort, 3000 above a
    1024-document threshold through the stream (and the pinned stream
    entry point)."""
    rng = np.random.default_rng(n)
    lens = rng.integers(10, 500, n).astype(np.int64)
    want = np.asarray(jpipe.bucket_by_length(lens, 8, external_threshold=threshold))
    ids = bucket_by_length(lens, 8, external_threshold=threshold, device="cpu")
    assert isinstance(ids, np.ndarray)
    np.testing.assert_array_equal(ids, want)
    assert sorted(ids.tolist()) == list(range(n))
    assert (np.diff(lens[ids]) >= 0).all()
    if threshold:
        ext = pipeline.bucket_by_length_external(lens, 8, chunk_docs=threshold, device="cpu")
        np.testing.assert_array_equal(ext, np.asarray(
            jpipe.bucket_by_length_external(lens, 8, chunk_docs=threshold)))


def test_bucket_by_length_takes_the_card_by_default():
    """The device rule: no device means the card, which must exist."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bucket_by_length(np.arange(10), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(PackedLoader(DataConfig(seq_len=16, global_batch=2, bucket_docs=64))))


def test_doc_lengths_are_the_corpus_draws():
    cfg = DataConfig(seq_len=64, mean_doc_len=50.0)
    docs = list(pipeline.SyntheticCorpus(cfg).docs(40))
    lens = pipeline.doc_lengths(np.random.default_rng((cfg.seed, cfg.host_id)), 40, cfg)
    np.testing.assert_array_equal([len(d) for d in docs], lens)


def test_loader_shapes_and_label_shift_match_repro():
    jit, it = both_loaders(seq_len=32, global_batch=4, grad_accum=2, vocab=100,
                           bucket_docs=128)
    for _ in range(2):
        b = next(it)
        assert_batches_equal(b, next(jit))
    assert b["tokens"].shape == (2, 4, 32) and b["labels"].shape == (2, 4, 32)
    np.testing.assert_array_equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    assert b["tokens"].max() < 100


def test_loader_deterministic_per_seed_and_host():
    mk = lambda seed, host: next(iter(PackedLoader(
        DataConfig(seq_len=16, global_batch=2, vocab=64, seed=seed, host_id=host,
                   bucket_docs=64), device="cpu")))
    a1, a2 = mk(0, 0), mk(0, 0)
    np.testing.assert_array_equal(a1["tokens"], a2["tokens"])
    b = mk(0, 1)
    assert not np.array_equal(a1["tokens"], b["tokens"])  # disjoint hosts
    assert_batches_equal(b, next(iter(jpipe.PackedLoader(jpipe.DataConfig(
        seq_len=16, global_batch=2, vocab=64, seed=0, host_id=1, bucket_docs=64)))))


def test_loader_streams_above_the_external_threshold_and_adds_frames():
    """Rounds of 256 documents above a 128-document threshold take the
    stream; whisper's config adds the seeded frames."""
    jit, it = both_loaders(smoke_config("whisper-base"), seq_len=16, global_batch=2,
                           grad_accum=2, vocab=64, bucket_docs=256, bucket_external_docs=128)
    b = next(it)
    assert b["frames"].shape == (2, 2, 16, 64)
    assert_batches_equal(b, next(jit))


# -------------------------------------------------------------- checkpoint


def _tree():
    rng = np.random.default_rng(4)
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": np.eye(3), "bf": torch.from_numpy(rng.standard_normal(5).astype(
                np.float32)).bfloat16()},
            "t": (torch.tensor([1, 2], dtype=torch.int32), np.int64(7))}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    d = save_checkpoint(str(tmp_path), 7, tree)
    assert sorted(os.listdir(d)) == ["COMMITTED", "arrays_0.npz", "tree.json"]
    assert latest_step(str(tmp_path)) == 7
    with np.load(os.path.join(d, "arrays_0.npz")) as z:
        assert sorted(z.files) == ["a", "b/bf", "b/c", "t/0", "t/1"]
        assert z["b/bf"].dtype == np.uint16
    template = {"a": torch.zeros(10), "b": {"c": np.zeros((3, 3)),
                                           "bf": torch.zeros(5, dtype=torch.bfloat16)},
                "t": (torch.zeros(2, dtype=torch.int32), np.int64(0))}
    a = template["a"]
    restored, step = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and restored["a"] is a  # tensors are restored in place
    np.testing.assert_array_equal(restored["b"]["c"], np.eye(3))
    assert torch.equal(restored["b"]["bf"], tree["b"]["bf"])
    assert torch.equal(restored["t"][0], tree["t"][0]) and int(restored["t"][1]) == 7
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), dict(template, a=torch.zeros(3)))


def test_checkpoint_layout_is_repros(tmp_path):
    """``repro``'s latest_step reads the port's directories, and the port's
    restore reads a step ``repro`` wrote when the names agree."""
    save_checkpoint(str(tmp_path / "port"), 3, {"w": torch.ones(4)})
    assert jckpt.latest_step(str(tmp_path / "port")) == 3
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, [jnp.arange(4.0)])
    os.rename(tmp_path / "jax" / "step_000000005" / "arrays_0.npz",
              tmp_path / "jax" / "x.npz")
    with np.load(tmp_path / "jax" / "x.npz") as z:
        np.savez(tmp_path / "jax" / "step_000000005" / "arrays_0.npz", **{"0": z["leaf_0"]})
    meta = tmp_path / "jax" / "step_000000005" / "tree.json"
    import json

    m = json.loads(meta.read_text())
    meta.write_text(json.dumps(dict(m, names=["0"])))
    out, step = restore_checkpoint(str(tmp_path / "jax"), [torch.zeros(4)])
    assert step == 5 and torch.equal(out[0], torch.arange(4.0))


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = save_checkpoint(str(tmp_path), 5, {"a": np.zeros(3)})
    os.remove(os.path.join(d, "COMMITTED"))
    assert latest_step(str(tmp_path)) is None
    assert restore_checkpoint(str(tmp_path), {"a": np.zeros(3)}) == (None, None)


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.zeros(4)}
    for s in (10, 20, 30, 40):
        mgr.save_async(s, tree)
    mgr.wait()
    mgr._gc()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [30, 40]


def _train_setup(seed=0):
    cfg = dataclasses.replace(smoke_config("deepseek-moe-16b"), dtype="float32")
    model = Model(cfg, device="cpu", seed=seed)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    params, ost = init_train_state(model, tcfg)
    return cfg, model, params, ost, make_train_step(model, tcfg)


def _state_bits(state) -> dict:
    from repro_torch.checkpoint.ckpt import _flatten

    return {n: convert.to_numpy(t).copy() for n, t in _flatten(state)}


def test_save_async_copies_before_the_next_step(tmp_path):
    """The in-place trap: ``save_async``, then a step (which writes the
    parameters and AdamW's states in place), then ``wait``: the checkpoint
    holds the state from before the step, bit for bit; restored into a
    fresh model and optimizer state it gives those bits back."""
    cfg, model, params, ost, step = _train_setup()
    loader = iter(PackedLoader(DataConfig(seq_len=32, global_batch=2, grad_accum=2,
                                          vocab=cfg.vocab, bucket_docs=64), device="cpu"))
    step(params, ost, 1, next(loader))
    before = _state_bits((params, ost))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(2, (params, ost))
    step(params, ost, 2, next(loader))
    mgr.wait()
    after = _state_bits((params, ost))
    assert any(not np.array_equal(before[n], after[n]) for n in before)
    _, fresh, fparams, fost, _ = _train_setup(seed=9)
    (rp, ro), s = mgr.restore_latest((fparams, fost))
    assert s == 2 and all(rp[n] is t for n, t in fparams.items())  # restored in place
    got = _state_bits((rp, ro))
    assert set(got) == set(before)
    for n in before:
        np.testing.assert_array_equal(got[n], before[n])
    assert all(fresh.get_parameter(n) is p for n, p in rp.items())


# ------------------------------------------------------------------- restart


def test_restart_manager_recovers(tmp_path):
    """A step that raises twice is retried from the last checkpoint; the
    port's manager counts as ``repro``'s on the same schedule."""
    def run(manager_cls, ckpt_cls):
        mgr = ckpt_cls(str(tmp_path / manager_cls.__module__), keep=3)
        rm = manager_cls(mgr, save_every=2, max_retries=5)
        calls = {"n": 0}

        def step_fn(state, step, batch):
            calls["n"] += 1
            if step == 3 and calls["n"] < 8:  # fail at step 3 a few times
                raise RuntimeError("simulated node failure")
            return ({"w": state[0]["w"] + 1}, state[1]), {"loss": 0.0}

        state, final = rm.run(({"w": np.zeros(2)}, {}), 0, 6, step_fn, lambda s: None)
        return state, final, rm.recoveries, calls["n"]

    got = run(RestartManager, CheckpointManager)
    want = run(jft.RestartManager, jckpt.CheckpointManager)
    assert got[1] == want[1] == 6 and got[2:] == want[2:] and got[2] >= 1
    np.testing.assert_array_equal(got[0][0]["w"], want[0][0]["w"])
    np.testing.assert_array_equal(got[0][0]["w"] >= 4, True)


def test_restart_manager_restores_a_train_state_in_place(tmp_path):
    """A real train step that raises once, after it has written part of
    the parameters: the manager restores the last checkpoint into the
    model's tensors and the run ends with one recovery, equal to a run
    without the fault."""
    def run(fail: bool):
        cfg, model, params, ost, step = _train_setup()
        data = DataConfig(seq_len=32, global_batch=2, grad_accum=2, vocab=cfg.vocab,
                          bucket_docs=64)
        batches = [b for _, b in zip(range(4), PackedLoader(data, device="cpu"))]
        rm = RestartManager(CheckpointManager(str(tmp_path / str(fail)), keep=2),
                            save_every=2)
        failed = []

        def step_fn(state, s, batch):
            if fail and s == 3 and not failed:
                failed.append(s)
                with torch.no_grad():
                    next(iter(state[0].values())).add_(1.0)  # a half-done update
                raise RuntimeError("simulated device error")
            p, o, m = step(*state, s, batch)
            return (p, o), m

        (p, o), final = rm.run((params, ost), 0, 4, step_fn, lambda s: batches[s])
        return _state_bits((p, o)), final, rm.recoveries

    clean, faulty = run(False), run(True)
    assert clean[1] == faulty[1] == 4 and (clean[2], faulty[2]) == (0, 1)
    for n in clean[0]:
        np.testing.assert_array_equal(faulty[0][n], clean[0][n])


def test_watchdog_flags_straggler():
    seq = [1.0 + np.random.default_rng(0).normal() * 1e-6 for _ in range(20)] + [10.0, 1.0]
    wd, jwd = Watchdog(k_sigma=3.0, warmup=3), jft.Watchdog(k_sigma=3.0, warmup=3)
    assert [wd.observe(t) for t in seq] == [jwd.observe(t) for t in seq]
    assert wd.stragglers == jwd.stragglers == 1
