"""The PyTorch port's overlap plane (``accl_tpu_torch.overlap``, the gang's
in-flight window) against the JAX package's.

* ``InflightWindow`` against ``accl_tpu/overlap.py``'s on the same
  scripted parks: completion order, depths, overlap witnesses,
  backpressure, per-key depths, ``drain_key`` on the drainer's own
  thread, ``stop``'s synchronous parks and a failing waiter, with equal
  ``stats()`` at every step;
* the gang: a request completes when the window retires its launch, the
  command ring's windows ride it (``ring_launched``), its counters equal
  ``xla_group(2)``'s on the same calls, and a failed device wait fails
  the launch's requests;
* the drain points: ``flush()``, ``set_inflight_window``,
  ``set_tenant_quota(window_share=...)`` and ``soft_reset`` wait for
  every call launched before them (nothing is in flight after each
  returns), bounded by ``drain_deadline_s``.
"""

import threading
import time

import numpy as np
import pytest

import accl_tpu.overlap as joverlap
from accl_tpu.core import xla_group
from helpers import run_parallel

import accl_tpu_torch as at
import accl_tpu_torch.overlap as toverlap
from accl_tpu_torch.backends.base import CallOptions
from accl_tpu_torch.constants import ConfigFunction, Operation

#: the window's counters that do not hang on a clock
COUNTS = ("depth", "key_depths", "in_flight", "max_depth_seen", "launched",
          "completed", "failed", "ring_launched", "ring_completed")


def _deinit(group):
    for a in group:
        a.deinit()


def _counts(w) -> dict:
    st = w.stats()
    return {k: st[k] for k in COUNTS}


def _script(mod, seed: int):
    """A seeded script of parks over three keys, each waiter released by
    the script in its key's order (and its completion awaited, so no
    step hangs on a thread's timing): per key the completion order with
    each entry's (overlapped, depth), and the window's counters after
    each release."""
    rng = np.random.default_rng(seed)
    w = mod.InflightWindow(depth=4, park_timeout_s=5.0)
    keys = ("a", "b", 7)
    gates, log, counts = [], {k: [] for k in keys}, []
    done = set()
    cv = threading.Condition()

    def release(j):
        key, gate = gates[j]
        gate.set()
        with cv:
            assert cv.wait_for(lambda: j in done, 5)
        st = _counts(w)
        st.pop("in_flight")  # the drainer pops after its completion ran
        counts.append(st)

    for i in range(12):
        key = keys[int(rng.integers(0, 3))]
        open_ = [j for j, (k, g) in enumerate(gates)
                 if k == key and not g.is_set()]
        if len(open_) >= 3:  # never block the script at the depth
            release(open_[0])
        gate = threading.Event()
        gates.append((key, gate))

        def on_ready(overlap, depth, _ns, key=key, i=i):
            with cv:
                log[key].append((i, overlap > 0, depth))
                done.add(i)
                cv.notify_all()

        w.park(key, lambda g=gate: g.wait(5), on_ready, lambda _e: None,
               ring=bool(i % 3 == 0))
    for j, (_key, gate) in enumerate(gates):
        if not gate.is_set():
            release(j)
    assert w.drain(10)
    final = _counts(w)
    w.stop()
    return log, counts, final


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_script_equals_jax(seed):
    """The same parks and releases on both windows: per key the same
    completion order, overlap witnesses and park depths, and equal
    counters after every release and at the end."""
    want = _script(joverlap, seed)
    got = _script(toverlap, seed)
    assert got == want
    assert got[2]["in_flight"] == 0
    assert got[2]["launched"] == got[2]["completed"] == 12


def test_backpressure_and_key_depth_equal_jax():
    """A key at its depth makes the next park wait for its oldest; a
    per-key depth of 1 serializes that key alone; widening wakes the
    parked launcher; both windows count alike."""
    for mod in (joverlap, toverlap):
        w = mod.InflightWindow(depth=2, park_timeout_s=5.0)
        release = threading.Event()
        noop = (lambda *_a: None, lambda _e: None)
        w.park("k", release.wait, *noop)
        w.park("k", release.wait, *noop)
        t = threading.Thread(target=w.park, args=("k", release.wait, *noop))
        t.start()
        time.sleep(0.1)
        assert t.is_alive() and w.in_flight() == 2  # the third waits
        w.set_key_depth("k", 3)  # widening lets it in
        t.join(5)
        assert not t.is_alive() and w.in_flight() == 3
        w.set_key_depth("other", 1)
        assert w.depth_for("other") == 1 and w.depth_for("k") == 3
        release.set()
        assert w.drain(5)
        assert w.stats()["max_depth_seen"] == 3
        assert w.stats()["key_depths"] == {"k": 3, "other": 1}
        w.stop()


def test_park_timeout_parks_over_depth():
    """A key wedged at its depth does not wedge the launcher: past
    ``park_timeout_s`` the park goes in over depth, as JAX's does."""
    for mod in (joverlap, toverlap):
        w = mod.InflightWindow(depth=1, park_timeout_s=0.1)
        release = threading.Event()
        w.park("k", release.wait, lambda *_: None, lambda _e: None)
        t0 = time.monotonic()
        w.park("k", release.wait, lambda *_: None, lambda _e: None)
        assert time.monotonic() - t0 < 2.0
        assert w.in_flight() == 2 and w.stats()["max_depth_seen"] == 2
        release.set()
        assert w.drain(5)
        w.stop()


def test_failing_waiter_stop_and_drain_key_equal_jax():
    """A waiter that raises reaches ``on_error`` and counts as failed;
    ``drain_key`` on the key's own drainer returns at once (a completion
    that re-enters must not wait on itself); after ``stop()`` a park
    completes on the launching thread."""
    for mod in (joverlap, toverlap):
        w = mod.InflightWindow(depth=4)
        errors, inner = [], []

        def boom():
            raise RuntimeError("device fault")

        w.park("k", boom, lambda *_: None, errors.append)

        def reenter(*_a):
            inner.append(w.drain_key("k", 1.0))

        w.park("k", lambda: None, reenter, lambda _e: None)
        assert w.drain(5)
        assert [type(e) for e in errors] == [RuntimeError]
        assert inner == [True]
        st = w.stats()
        assert (st["failed"], st["completed"], st["launched"]) == (1, 2, 2)
        w.stop()
        here = []
        w.park("k", lambda: None,
               lambda *_a: here.append(threading.current_thread()),
               lambda _e: None)
        assert here == [threading.current_thread()]
        assert w.stats()["launched"] == w.stats()["completed"] == 3


@pytest.mark.parametrize("env,want", [(None, 4), ("1", 1), ("16", 16),
                                      ("999", 64), ("0", 1), ("x", 4)])
def test_default_window_depth_equals_jax(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("ACCL_INFLIGHT_WINDOW", raising=False)
    else:
        monkeypatch.setenv("ACCL_INFLIGHT_WINDOW", env)
    assert toverlap.default_window_depth() == \
        joverlap.default_window_depth() == want


@pytest.mark.parametrize("passed", [True, False])
def test_device_waiter(passed):
    """A launch with no event (the CPU) waits for nothing; one with an
    event, an ``EventGroup`` or a run's ticket asks first and waits on
    its ``synchronize`` only while its work has not ended."""
    assert toverlap.device_waiter(None)() is None
    hits = []

    class Ev:
        def query(self):
            hits.append("query")
            return passed

        def synchronize(self):
            hits.append("synchronize")

    toverlap.device_waiter(Ev())()
    assert hits == (["query"] if passed else ["query", "synchronize"])


# ---------------------------------------------------------------------------
# the gang
# ---------------------------------------------------------------------------

def _hold(group, comm_id):
    """Park an entry on ``comm_id`` in the gang's window that waits for
    the returned event: every launch of the comm queues behind it."""
    gate = threading.Event()
    group[0].engine.gang.window.park(
        comm_id, lambda: gate.wait(30), lambda *_a: None, lambda _e: None)
    return gate


def _calls(group, n=64):
    send = [a.create_buffer_from(np.full(n, r + 1.0, np.float32))
            for r, a in enumerate(group)]
    recv = [a.create_buffer(n, np.float32) for a in group]
    return send, recv


def _window_counts(group) -> dict:
    return _counts(group[0].engine.gang.window)


def _gang_sequence(group):
    """Sync and async allreduces, a batch of 3 (one ring window), a
    barrier, a pipelined allreduce and a host-only call: the window's
    counters after each step."""
    send, recv = _calls(group)
    hs = [a.create_buffer_from(np.ones(64, np.float32), host_only=True)
          for a in group]
    steps = []

    def step(fn):
        run_parallel(group, fn)
        for a in group:
            a.flush()
        steps.append(_window_counts(group))

    step(lambda a, r: a.allreduce(send[r], recv[r], 64))

    def burst(a, r):
        qs = [a.allreduce(send[r], recv[r], 64, run_async=True)
              for _ in range(3)]
        for q in qs:
            assert q.wait(30)
            q.check()

    step(burst)

    def batch(a, r):
        with a.batch():
            qs = [a.allreduce(send[r], recv[r], 64, run_async=True)
                  for _ in range(3)]
        for q in qs:
            assert q.wait(30)
            q.check()

    step(batch)
    step(lambda a, r: a.barrier())
    step(lambda a, r: a.allreduce(hs[r], hs[r], 64))
    for a in group:
        a.set_tuning("ring_segments", 2)
        a.set_tuning("pipeline_threshold", 128)
    step(lambda a, r: a.allreduce(send[r], recv[r], 64))
    return steps


def test_gang_window_counters_equal_jax():
    """The window's launches on the gang equal JAX's gang's, call by
    call: one a device call, one a ring window (``ring_launched``), one a
    fused or pipelined segment, none for a barrier or a host-staged
    call; every launch completed after each drain."""
    jg = xla_group(2)
    try:
        want = _gang_sequence(jg)
    finally:
        _deinit(jg)
    tg = at.cuda_group(2, device="cpu")
    try:
        got = _gang_sequence(tg)
    finally:
        _deinit(tg)
    for g_, w_ in zip(got, want):
        g_.pop("max_depth_seen"), w_.pop("max_depth_seen")  # timing
    assert got == want
    assert got[-1]["ring_launched"] == 1
    assert all(s["in_flight"] == 0 and s["launched"] == s["completed"]
               for s in got)


def test_request_completes_when_the_window_retires_it():
    """A launched call is not done while the window holds it, then
    completes with the window's depth; a synchronous call of the same
    comm waits behind it."""
    g = at.cuda_group(2, device="cpu")
    try:
        send, recv = _calls(g)
        gate = _hold(g, g[0].comm.id)
        reqs = run_parallel(g, lambda a, r: a.allreduce(
            send[r], recv[r], 64, run_async=True))
        time.sleep(0.05)
        assert not any(q.done() for q in reqs)
        assert not any(q.test() for q in reqs)
        gate.set()
        for q in reqs:
            assert q.wait(30)
            q.check()
            assert q.inflight_depth == 2 and q.overlap_ns is None
        np.testing.assert_array_equal(
            np.asarray(recv[0].device_view()[:64]), np.full(64, 3.0))
    finally:
        _deinit(g)


def test_failed_device_wait_fails_the_requests():
    """A launch whose wait raises (a kernel fault surfacing at its
    event) fails every request of the launch with INVALID_OPERATION and
    the error, from the drainer, in time."""
    from accl_tpu_torch.request import Request

    g = at.cuda_group(2, device="cpu")
    try:
        gang = g[0].engine.gang

        class Faulted:
            def query(self):
                return False

            def synchronize(self):
                raise RuntimeError("an illegal memory access")

        reqs = [Request(op_name="ALLREDUCE") for _ in range(2)]
        gang._park_inflight(0, reqs, Faulted(), time.perf_counter_ns())
        for q in reqs:
            assert q.wait(5)
            with pytest.raises(at.ACCLError) as e:
                q.check()
            assert e.value.code & at.ErrorCode.INVALID_OPERATION
            assert "illegal memory access" in e.value.details["error"]
        assert gang.window.stats()["failed"] == 1
    finally:
        _deinit(g)


# ---------------------------------------------------------------------------
# the drain points
# ---------------------------------------------------------------------------

def _flush(group):
    for a in group:
        a.flush()


def _set_window(group):
    for a in group:
        a.set_inflight_window(6)


def _window_share(group):
    run_parallel(group, lambda a, r: a.set_tenant_class("burst"))
    for a in group:
        a.set_tenant_quota(window_share=3)


def _soft_reset(group):
    run_parallel(group, lambda a, r: a.soft_reset())


@pytest.mark.parametrize("drain", [_flush, _set_window, _window_share,
                                   _soft_reset],
                         ids=["flush", "set_inflight_window",
                              "window_share", "soft_reset"])
def test_drain_points_wait_for_every_launched_call(drain):
    """Each drain point waits while a launched call is held in the
    window, and returns with nothing in flight: every call launched
    before it has completed."""
    g = at.cuda_group(2, device="cpu")
    try:
        send, recv = _calls(g)
        gate = _hold(g, g[0].comm.id)
        reqs = run_parallel(g, lambda a, r: [
            a.allreduce(send[r], recv[r], 64, run_async=True)
            for _ in range(2)])
        done = threading.Event()

        def run():
            drain(g)
            done.set()

        t = threading.Thread(target=run)
        t.start()
        assert not done.wait(0.2)  # held: the drain point waits
        assert g[0].engine.gang.window.in_flight() == 3
        gate.set()
        t.join(30)
        assert done.is_set() and not t.is_alive()
        assert g[0].engine.gang.window.in_flight() == 0
        assert all(q.done() for qs in reqs for q in qs)
        for qs in reqs:
            for q in qs:
                q.check()
    finally:
        _deinit(g)


def test_drain_points_are_bounded(monkeypatch):
    """With a call held past the drain deadline, ``flush()`` raises
    DEADLOCK_SUSPECTED and ``set_inflight_window`` fails RECEIVE_TIMEOUT
    instead of hanging (the deadline shortened here; it is
    ``drain_deadline_s`` of the timeout, 60 s at least)."""
    import accl_tpu_torch.backends.cuda.engine as eng
    import accl_tpu_torch.core as core

    monkeypatch.setattr(core, "drain_deadline_s", lambda t: 0.2)
    monkeypatch.setattr(eng, "drain_deadline_s", lambda t: 0.2)
    g = at.cuda_group(2, device="cpu")
    gate = None
    try:
        send, recv = _calls(g)
        gate = _hold(g, g[0].comm.id)
        reqs = run_parallel(g, lambda a, r: a.allreduce(
            send[r], recv[r], 64, run_async=True))
        t0 = time.monotonic()
        with pytest.raises(at.ACCLError) as e:
            g[0].flush()
        assert e.value.code & at.ErrorCode.DEADLOCK_SUSPECTED
        with pytest.raises(at.ACCLError) as e:
            g[0].engine.start(CallOptions(
                op=Operation.CONFIG,
                cfg_function=int(ConfigFunction.SET_INFLIGHT_WINDOW),
                cfg_value=2)).check()
        assert e.value.code & at.ErrorCode.RECEIVE_TIMEOUT
        assert time.monotonic() - t0 < 10
        gate.set()
        for q in reqs:
            assert q.wait(30)
    finally:
        if gate is not None:
            gate.set()
        _deinit(g)


def test_window_stops_with_the_last_engine():
    """The last rank handle's deinit drains and stops the window (no
    drainer thread left); a park after it completes at once."""
    g = at.cuda_group(2, device="cpu")
    send, recv = _calls(g)
    run_parallel(g, lambda a, r: a.allreduce(send[r], recv[r], 64))
    window = g[0].engine.gang.window
    g[0].deinit()
    assert not window._stopped
    g[1].deinit()
    assert window._stopped and window.in_flight() == 0
    assert not window._threads  # every drainer joined
    hit = []
    window.park(0, lambda: None, lambda *_a: hit.append(1), lambda _e: None)
    assert hit == [1]


def test_window_under_thread_stress():
    """Eight launcher threads (more than a test worker's share of cores)
    park on three keys with the interpreter switching threads every
    microsecond: no completion is lost or run twice, each key completes
    in its park order, and the depth bound holds."""
    import sys

    w = toverlap.InflightWindow(depth=3, park_timeout_s=10.0)
    done = {k: [] for k in range(3)}
    lock = threading.Lock()
    order = {k: [] for k in range(3)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def launcher(t):
            for i in range(40):
                key = (t + i) % 3
                tag = (t, i)
                with lock:  # park order, recorded under the same lock
                    order[key].append(tag)
                    w.park(key, lambda: time.sleep(0.0001),
                           lambda *_a, k=key, tag=tag: done[k].append(tag),
                           lambda _e: None)

        threads = [threading.Thread(target=launcher, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert w.drain(30)
    finally:
        sys.setswitchinterval(old)
    st = w.stats()
    assert st["launched"] == st["completed"] == 320 and st["failed"] == 0
    assert st["max_depth_seen"] <= 3 and st["in_flight"] == 0
    for k in range(3):
        assert done[k] == order[k]
    w.stop()
