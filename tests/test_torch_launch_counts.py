"""Launch counting and the kernel library's build under several threads
(ops/_build.py): data-parallel replicas launch from their own threads.

  - 8 threads counting launches lose none (each wrapper's ``.launches``
    changes under a lock);
  - a CUDA graph capture's tally is its own thread's: another thread's
    launches meanwhile go to the counters;
  - 8 threads running a wrapper's plain path at once give the one-thread
    results;
  - ``lib()`` builds once when many threads reach it first at once.
"""

import threading
import time

import numpy as np
import torch

from norma_tpu_torch.ops import _build
from norma_tpu_torch.ops import sample_step as ss


def _fake_counter():
    def fn():
        pass

    fn.launches = 0
    return fn


class _YieldingCounter:
    """A counter whose read hands the GIL to another thread before its
    write, as a free-threaded interpreter may at any point: an unlocked
    ``+=`` loses counts on it."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, n):
        self._n = n


def test_eight_threads_lose_no_count():
    fn = _YieldingCounter()
    n = 2000
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(n):
            _build.count(fn)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == 8 * n


def test_capture_tally_is_thread_local():
    fn = _fake_counter()
    recording, done = threading.Event(), threading.Event()
    tallies = []

    def capture():
        with _build.recording_launches() as tally:
            _build.count(fn, 3)
            recording.set()
            done.wait(10)
            tallies.append(dict(tally))

    t = threading.Thread(target=capture)
    t.start()
    recording.wait(10)
    _build.count(fn, 5)  # another thread, while the capture records
    done.set()
    t.join()
    assert fn.launches == 5 and tallies == [{fn: 3}]
    _build.count_all(tallies[0])  # a replay
    assert fn.launches == 8


def _step_inputs(B=6, V=300, seed=0):
    rng = np.random.default_rng(seed)
    ll = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    masks = [torch.from_numpy((rng.random(V) < p).astype(np.float32)) for p in (0.02, 0.7, 0.3, 0.1)]
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return ll, masks, i32(rng.integers(0, V, B)), i32(rng.integers(0, V, B)), i32(np.zeros(B))


def test_plain_path_from_eight_threads():
    ll, masks, p1, p2, lts = _step_inputs()
    temp = torch.zeros(ll.shape[0])
    call = lambda: ss.sample_step(ll, *masks, p1, p2, lts, 3, temp, eot=10, no_timestamps=200, seed=0,
                                  greedy_only=True)
    want = call()
    before = ss.sample_step.launches
    results = [None] * 8

    def work(i):
        results[i] = call()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in results:
        assert all(torch.equal(a, b) for a, b in zip(r, want))
    assert ss.sample_step.launches == before  # the plain path launches nothing


def test_lib_builds_once_under_contention(monkeypatch):
    builds = []

    class FakeFn:
        argtypes = restype = None

    class FakeLib:
        def __getattr__(self, name):
            f = FakeFn()
            setattr(self, name, f)
            return f

    def fake_build():
        builds.append(threading.get_ident())
        return "libfake.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    start = threading.Barrier(8)
    got = []

    def work():
        start.wait()
        got.append(_build.lib())

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len({id(x) for x in got}) == 1
