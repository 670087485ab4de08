"""The kernel build and load (``nbody_tpu_torch/ops/_build.py``) and the
wrappers' launch counters under concurrent callers, on the CPU: CUDA's
presence, the build and ``ctypes.CDLL`` are faked."""

import ctypes
import sys
import threading
import time
import types

import pytest
import torch

from nbody_tpu_torch.ops import _build, work
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import pairwise as pw


class FakeLib:
    """Stands in for the loaded library: any entry point accepts its
    argtypes and restype."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_load_library_builds_and_loads_once_from_four_threads(monkeypatch,
                                                              tmp_path):
    builds, loads = [], []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a cold build: the other threads arrive meanwhile
        return tmp_path / "libfake.so"

    def cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_LIB", None)
    start = threading.Barrier(4)
    got = []

    def call():
        start.wait()
        got.append(_build.load_library())

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert got[0].nbody_group_force.restype is ctypes.c_int


def test_build_names_its_files_by_thread(monkeypatch, tmp_path):
    """Two threads' builds never share an object or temporary name, and a
    second caller waits for the first build and reuses its library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    names = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            names.append((threading.get_ident(), cmd[cmd.index("-o") + 1]))

        def communicate(self, timeout=None):
            return "", None

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        names.append((threading.get_ident(), out))
        time.sleep(0.1)
        open(out, "w").close()
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(_build.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(libs) == 2 and libs[0] == libs[1] and libs[0].exists()
    # one build ran (the second thread found the library), and its
    # temporary names carry the pid and the thread id
    tids = {tid for tid, _ in names}
    assert len(tids) == 1
    tid = tids.pop()
    assert all(f".{tid}." in name for _, name in names)


def test_launch_counters_lose_no_update():
    """Many threads counting launches at once, with the interpreter
    switching threads as often as it can: every launch is counted."""
    pw.reset_launch_counts()
    gf.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(2000):
                pw._launched("pairwise_acc_sym")
                gf._launched("quad_force")

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert pw.launch_counts()["pairwise_acc_sym"] == 16000
    assert gf.launch_counts()["quad_force"] == 16000
    pw.reset_launch_counts()
    gf.reset_launch_counts()


def test_work_counts_need_an_open_count():
    calls = []
    work.record("x", "pair", lambda: calls.append(1) or (1, 1))
    assert calls == []
    with work.counting() as c:
        work.record("x", "pair", lambda: (3, 10))
        work.record("x", "sym", lambda: (2, 5))
    assert c.flops == {"x": 3 * 18 + 2 * 25} and c.bytes == 15
    with pytest.raises(KeyError):
        with work.counting():
            work.record("x", "other", lambda: (1, 1))
