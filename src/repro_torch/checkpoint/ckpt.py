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

A sharded train state is saved by every rank, each its own blocks
(``host_id`` = rank, ``n_hosts`` ranks), into one step directory::

    <dir>/step_000123/
        arrays_<rank>.npz   the rank's blocks
        tree_<rank>.json    their names, dtypes and shapes
        mesh.json           the mesh shape and the number of ranks
        COMMITTED_<rank>    each rank's marker, written last

and the step is valid once every rank's marker is there. A state saved on
one mesh shape restores only on the same shape: another raises a
ValueError naming both (re-sharding on restore is ``repro``'s elastic
path, which does not run on jax 0.9).

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


def _meta(step: int, host: list, dtypes: list) -> dict:
    return {
        "step": step,
        "n_leaves": len(host),
        "names": [name for name, _ in host],
        "dtypes": dtypes,
        "shapes": [list(a.shape) for _, a in host],
    }


def _write_shard(path: str, step: int, host: list, dtypes: list, host_id: int,
                 n_hosts: int, mesh_shape: dict) -> str:
    """One rank's blocks into the shared step directory (module docstring)."""
    final = os.path.join(path, f"step_{step:09d}")
    os.makedirs(final, exist_ok=True)
    tmp = os.path.join(final, f".tmp_{host_id}")
    np.savez(tmp + ".npz", **dict(host))
    os.replace(tmp + ".npz", os.path.join(final, f"arrays_{host_id}.npz"))
    for name, obj in ((f"tree_{host_id}.json", _meta(step, host, dtypes)),
                      ("mesh.json", {"mesh_shape": mesh_shape, "n_hosts": n_hosts})):
        with open(tmp + ".json", "w") as f:
            json.dump(obj, f)
        os.replace(tmp + ".json", os.path.join(final, name))
    with open(os.path.join(final, f"COMMITTED_{host_id}"), "w") as f:
        f.write("ok")
    return final


def _write(path: str, step: int, host: list, dtypes: list, host_id: int, n_hosts: int = 1,
           mesh_shape: dict | None = None) -> str:
    if mesh_shape is not None:
        return _write_shard(path, step, host, dtypes, host_id, n_hosts, mesh_shape)
    tmp = os.path.join(path, f".tmp_step_{step:09d}_{host_id}")
    final = os.path.join(path, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"arrays_{host_id}.npz"), **dict(host))
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(_meta(step, host, dtypes), f)
    os.makedirs(path, exist_ok=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker last: restore only trusts committed checkpoints
    with open(os.path.join(final, "COMMITTED"), "w") as f:
        f.write("ok")
    return final


def save_checkpoint(path: str, step: int, tree, host_id: int = 0, n_hosts: int = 1,
                    mesh_shape: dict | None = None) -> str:
    """``mesh_shape``: a sharded state, one of ``n_hosts`` ranks' blocks."""
    host, dtypes = _host_tree(tree)
    return _write(path, step, host, dtypes, host_id, n_hosts, mesh_shape)


def _mesh_of(d: str) -> dict | None:
    """The step directory's mesh.json, or None (a one-rank checkpoint)."""
    p = os.path.join(d, "mesh.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _committed(d: str) -> bool:
    if os.path.exists(os.path.join(d, "COMMITTED")):
        return True
    mesh = _mesh_of(d)
    return mesh is not None and all(
        os.path.exists(os.path.join(d, f"COMMITTED_{h}")) for h in range(mesh["n_hosts"]))


def _committed_steps(path: str) -> list:
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and _committed(os.path.join(path, d)))


def latest_step(path: str) -> int | None:
    steps = _committed_steps(path)
    return steps[-1] if steps else None


def _decode(arr: np.ndarray, dtype_name: str):
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


@torch.no_grad()
def restore_checkpoint(path: str, tree_template, step: int | None = None, host_id: int = 0,
                       mesh_shape: dict | None = None):
    """Restore into the template: tensor leaves are overwritten in place,
    numpy leaves replaced by the loaded arrays. Returns (tree, step), or
    (None, None) when there is no committed step. ``mesh_shape``: the
    sharded state's mesh, which must be the checkpoint's (ValueError
    otherwise)."""
    step = latest_step(path) if step is None else step
    if step is None:
        return None, None
    d = os.path.join(path, f"step_{step:09d}")
    saved = _mesh_of(d)
    saved_shape = None if saved is None else saved["mesh_shape"]
    if saved_shape != (None if mesh_shape is None else dict(mesh_shape)):
        raise ValueError(f"the checkpoint at step {step} was saved on mesh "
                         f"{saved_shape or 'of one rank'}, and this state is on mesh "
                         f"{mesh_shape or 'of one rank'}: re-sharding on restore is not "
                         f"ported")
    tree = "tree.json" if saved is None else f"tree_{host_id}.json"
    with open(os.path.join(d, tree)) as f:
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
    """Async writer + retention policy + restart helper. A sharded state's
    manager on each rank: ``host_id`` the rank, ``n_hosts`` the ranks,
    ``mesh_shape`` the mesh's; rank 0 alone drops old steps."""

    def __init__(self, path: str, keep: int = 3, host_id: int = 0, n_hosts: int = 1,
                 mesh_shape: dict | None = None):
        self.path = path
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.mesh_shape = None if mesh_shape is None else dict(mesh_shape)
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
            _write(self.path, step, host, dtypes, self.host_id, self.n_hosts,
                   self.mesh_shape)
            if self.host_id == 0:
                self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _committed_steps(self.path)[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"), ignore_errors=True)

    def restore_latest(self, template):
        self.wait()
        return restore_checkpoint(self.path, template, host_id=self.host_id,
                                  mesh_shape=self.mesh_shape)
