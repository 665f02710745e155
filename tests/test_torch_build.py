"""Threads of one process and the CUDA kernels' build and launch counts:
concurrent first calls build a library once (``kernels/build.py``'s lock
per source, temporary files named by process and thread), and the
wrappers' launch counts lose no increment under concurrent launches. The
compiler is stubbed (``build._run``), so these run without nvcc. Two
processes building at once take turns on the file lock and compile once.
"""
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import pytest

from repro_torch.kernels import bitonic, build, flash


def _fake_source(monkeypatch, tmp_path, units=None):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    if units is not None:
        monkeypatch.setattr(build, "UNITS", {"fake": units})
    calls, lock = [], threading.Lock()

    def run(cmd):
        with lock:
            calls.append(cmd)
        time.sleep(0.2)  # long enough for a second builder to arrive
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"object")
        return 0, " ".join(cmd) + "\n"

    monkeypatch.setattr(build, "_run", run)
    return calls


def _build_twice():
    paths, errors = [], []

    def go():
        try:
            paths.append(build.build("fake"))
        except Exception as e:  # noqa: BLE001 — the assertion reports it
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    return paths


@pytest.mark.parametrize("units", [None, ("-DU=0", "-DU=1", "-DU=2")])
def test_concurrent_first_builds_build_once(monkeypatch, tmp_path, units):
    calls = _fake_source(monkeypatch, tmp_path, units)
    paths = _build_twice()
    assert paths[0] == paths[1] == build.library_path("fake") and paths[0].exists()
    assert len(calls) == (1 if units is None else len(units) + 1)  # compiles (+ one link)
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert left == sorted([paths[0].name, paths[0].with_suffix(".log").name, "libfake.lock"])
    tags = {re.search(r"\.(\d+-\d+)\.", c[c.index("-o") + 1]).group(1) for c in calls}
    assert len(tags) == 1  # one builder: its files carry its pid and thread


_PROCESS_BUILDER = """
import pathlib, sys, time
from repro_torch.kernels import build
tmp = pathlib.Path(sys.argv[1])
build.CSRC, build.BUILD_DIR = tmp / "csrc", tmp / "build"
build.nvcc_path = lambda: "nvcc"

def run(cmd):
    with open(tmp / "calls.txt", "a") as f:
        f.write(" ".join(cmd) + "\\n")
    time.sleep(0.5)  # long enough for the other process to arrive
    pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"object")
    return 0, " ".join(cmd) + "\\n"

build._run = run
print(build.build("fake"))
"""


def test_concurrent_builds_in_two_processes_build_once(tmp_path):
    """Two processes started together (a mesh sort's ranks) compile once:
    the second waits on ``build/libfake.lock`` and finds the library."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// a source\n")
    src = str(pathlib.Path(build.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS_BUILDER, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    built = {out.strip() for out, _ in outs}
    assert len(built) == 1 and pathlib.Path(built.pop()).exists()
    assert len((tmp_path / "calls.txt").read_text().splitlines()) == 1


def test_launch_counts_lose_no_update_under_threads():
    """More threads than cores bumping the counts through the same helper
    the wrappers call at their launch sites, with a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        bitonic.reset_launches()
        flash_before = flash.flash_attention.launches

        def work():
            for i in range(2000):
                bitonic._count(bitonic.bitonic_merge_rows, i % 2 == 0)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert bitonic.bitonic_merge_rows.launches == 16 * 2000
    assert bitonic.bitonic_merge_rows.wide_launches == 16 * 1000
    assert flash.flash_attention.launches == flash_before
    bitonic.reset_launches()
    assert all(fn.launches == fn.wide_launches == 0 for fn in bitonic.KERNELS)
