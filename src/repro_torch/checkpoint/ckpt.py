"""Checkpointing with async commit and restart: ``repro/checkpoint/ckpt.py``.

Layout (``repro``'s, no external deps)::

    <dir>/step_000123/
        arrays_<host>.npz   this host's leaves, keyed by their names
        tree.json           leaf names, dtypes and shapes
        COMMITTED           marker written last

A tree is nested dicts, lists and tuples of tensors or numpy arrays (the
train state is ``(params, opt_state)``, dicts keyed by ``state_dict``
names); a leaf's name is its path, joined by "/" (``0/embed.table``,
``1/m/layers.0.mix.wq``). numpy has no bfloat16, so a bfloat16 leaf is
stored as its uint16 bits and re-viewed on restore from the recorded
dtype.

Fault-tolerance contract: a checkpoint is valid iff COMMITTED exists;
readers pick the newest valid step; writers write to a temporary
directory and rename it, so a node dying mid-save never corrupts the
restore state.

``repro``'s arrays are immutable, so its ``save_async`` can serialize them
from a thread while training goes on. The port updates its parameters
and optimizer states in place, so ``save_async`` copies the whole tree to
host memory before it returns and the thread writes only that copy: a
step taken right after it cannot reach the checkpoint. ``restore_*``
copies the checkpoint into the template's tensors in place (they are the
model's parameters), and returns the template's structure.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list:
    """(name, leaf) for every leaf, in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory (bfloat16 as its uint16 bits); a
    device tensor is copied synchronously, so the copy is whole on return."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf, copy=True)


def _host_tree(tree) -> tuple[list, list]:
    """((name, host copy) for every leaf, the leaves' dtype names)."""
    leaves = _flatten(tree)
    return ([(name, _to_host(leaf)) for name, leaf in leaves],
            [_dtype_name(leaf) for _, leaf in leaves])


def _write(path: str, step: int, host: list, dtypes: list, host_id: int) -> str:
    tmp = os.path.join(path, f".tmp_step_{step:09d}_{host_id}")
    final = os.path.join(path, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"arrays_{host_id}.npz"), **dict(host))
    meta = {
        "step": step,
        "n_leaves": len(host),
        "names": [name for name, _ in host],
        "dtypes": dtypes,
        "shapes": [list(a.shape) for _, a in host],
    }
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(meta, f)
    os.makedirs(path, exist_ok=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker last: restore only trusts committed checkpoints
    with open(os.path.join(final, "COMMITTED"), "w") as f:
        f.write("ok")
    return final


def save_checkpoint(path: str, step: int, tree, host_id: int = 0) -> str:
    host, dtypes = _host_tree(tree)
    return _write(path, step, host, dtypes, host_id)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and os.path.exists(os.path.join(path, d, "COMMITTED")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _decode(arr: np.ndarray, dtype_name: str):
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


@torch.no_grad()
def restore_checkpoint(path: str, tree_template, step: int | None = None, host_id: int = 0):
    """Restore into the template: tensor leaves are overwritten in place,
    numpy leaves replaced by the loaded arrays. Returns (tree, step), or
    (None, None) when there is no committed step."""
    step = latest_step(path) if step is None else step
    if step is None:
        return None, None
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "tree.json")) as f:
        meta = json.load(f)
    dtypes = dict(zip(meta["names"], meta["dtypes"]))
    leaves = _flatten(tree_template)
    with np.load(os.path.join(d, f"arrays_{host_id}.npz")) as data:
        new = []
        for name, old in leaves:
            if name not in dtypes:
                raise ValueError(f"checkpoint has no leaf {name!r}")
            arr = _decode(data[name], dtypes[name])
            if tuple(np.shape(old)) != tuple(arr.shape):
                raise ValueError(f"checkpoint shape mismatch: {np.shape(old)} vs {arr.shape}")
            if isinstance(old, torch.Tensor):
                old.copy_(torch.as_tensor(arr))
                new.append(old)
            else:
                new.append(arr)
    return _unflatten(tree_template, iter(new)), step


class CheckpointManager:
    """Async writer + retention policy + restart helper."""

    def __init__(self, path: str, keep: int = 3, host_id: int = 0):
        self.path = path
        self.keep = keep
        self.host_id = host_id
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree):
        """Copy ``tree`` to host memory now, then write it from a thread."""
        self.wait()
        host, dtypes = _host_tree(tree)

        def work():
            _write(self.path, step, host, dtypes, self.host_id)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        if not os.path.isdir(self.path):
            return
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.path)
            if d.startswith("step_")
            and os.path.exists(os.path.join(self.path, d, "COMMITTED"))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"), ignore_errors=True)

    def restore_latest(self, template):
        self.wait()
        return restore_checkpoint(self.path, template, host_id=self.host_id)
