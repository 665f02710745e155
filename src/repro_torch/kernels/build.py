"""Build the port's CUDA sources into a shared library and load it.

The sources under ``kernels/csrc/`` have a plain C interface. They are
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root, at first use, and loaded with ``ctypes``. The library's file name
carries a hash of its source and flags, so an edited source builds anew
and an unchanged one is reused.

A source listed in ``UNITS`` is compiled once per unit (each with its own
``-D`` flag, all at once, one ``nvcc`` each) and the objects are linked
into one library: ``bitonic.cu`` instantiates about a thousand kernels,
which one compiler process would take many minutes over.

Calls that build one library take turns: threads of a process through a lock
per source, processes through an ``fcntl.flock`` on
``build/lib<name>.lock`` taken inside it. A process that waited finds the
library built and loads it, so ranks started together (a mesh sort's
processes) run ``nvcc`` once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# csrc/bitonic.cu: units 0-9 instantiate the row sorts and the merges of
# one key type each, unit 10 holds the entry points (see its header)
UNITS = {"bitonic": tuple(f"-DBITONIC_UNIT={u}" for u in range(11))}

# one lock per source: threads of one process that need the same library
# at once (the sort server's flush loop and its workers) build it once
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which("nvcc", path=f"{cuda_home}/bin")
    if found is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of repro_torch are built at first use on a machine "
            "with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *UNITS.get(name, ()))).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _run(cmd: list) -> tuple[int, str]:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills; every unit's, in turn) is kept beside the library as
    ``<library>.log``. Concurrent calls build once, in one process (a lock
    per source) or in several (a file lock per source, ``lib<name>.lock``);
    the temporary files are named by process and thread."""
    with _lock(name):
        if library_path(name).exists():
            return library_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            return _build(name)


def _build(name: str) -> pathlib.Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp = out.with_suffix(f".{tag}.tmp")
    src = str(CSRC / f"{name}.cu")
    units = UNITS.get(name)
    if units is None:
        steps = [_run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), src])]
    else:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [out.with_suffix(f".{tag}.{u}.o") for u in range(len(units))]
        with ThreadPoolExecutor(len(units)) as pool:  # one nvcc per unit, started together
            steps = list(pool.map(_run, [[nvcc_path(), *flags, d, "-c", "-o", str(o), src]
                                         for d, o in zip(units, objs)]))
        if all(rc == 0 for rc, _ in steps):
            steps.append(_run([nvcc_path(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)]))
        for o in objs:
            o.unlink(missing_ok=True)
    log = "".join(text for _, text in steps)
    out.with_suffix(".log").write_text(log)
    if any(rc != 0 for rc, _ in steps):
        raise RuntimeError(f"nvcc failed building {name}.cu:\n"
                           + "".join(text for rc, text in steps if rc != 0))
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
