"""The ring across processes: the push's chunk indices and the registered
receive windows (``exchange/windows.py``).

The push (``exchange/ring.py::push_targets``, the arithmetic of
``csrc/ring_exchange.cu``'s kernel) is held in this process
against the flat routing of ``exchange/hierarchical.py`` (``_route(...,
0)``, what ``all_to_all_single`` moves across processes), for P = 2, 4
and 8 processes of an 8-partition job, one round and three.

The windows are held in two gloo CPU processes of 4 partitions (four
processes of 2 in the ``slow`` test), where each window is a POSIX
shared-memory block. The worker is this file run
as a script (``python tests/test_torch_ring_windows.py RANK WORLD
INIT_FILE OUT_DIR``, no JAX, killed past 120 s); one pair of workers
runs every scenario and the tests read its results:

- growth and closing: a window maps at its first move, grows (a new
  block, the old one unlinked) when a move needs more room, and is
  unlinked when its scope closes;
- back-to-back moves of different data while process 0 reads its window
  slowly: no process's next push lands before every process has read
  the last move's words;
- two service sessions' scopes at once, in two threads: their windows
  stay apart, and each session's raw moves and its shuffle read give
  what one process gives;
- a fault that fires on every process alike (``exchange.dispatch`` and
  ``exchange.stream_round``): the reader's retry gives the fault-free
  output.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
D = 8
WORKER_S = 120
#: back-to-back moves, and process 0's sleep before it reads each
MOVES, SLOW_S = 3, 0.3
#: each session's tenant and seed, and its raw moves
TENANTS = {"alice": 21, "bob": 22}
SESSION_MOVES = 3
PER = 24


def _send(seed: int, local: int, rounds: int, chunk: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, size=(local, rounds, D, chunk),
        dtype=np.int64).astype(np.int32)


def _expected(sends: list, q: int) -> np.ndarray:
    """Process ``q``'s receive from every process's send ``[L, R, D,
    C]``: ``recv_q[l', r, p*L + l] = send_p[l, r, q*L + l']``."""
    local = sends[0].shape[0]
    out = np.empty((local,) + sends[0].shape[1:], np.int32)
    for p, send in enumerate(sends):
        out[:, :, p * local:(p + 1) * local] = \
            send[:, :, q * local:(q + 1) * local].transpose(2, 1, 0, 3)
    return out


# --- the push's chunk indices, in this process ---------------------------
def _routed(sends: list, procs: int) -> list:
    """Every process's ``[L, D, C]`` after the flat routing of
    ``hierarchical._route(D, procs, me, 1, 0)``, with the
    ``all_to_all_single`` between them played here."""
    from sparkrdma_tpu_torch.exchange.hierarchical import _route

    routes = [_route(D, procs, me, 1, 0) for me in range(procs)]
    outgoing = []
    for send, route in zip(sends, routes):
        flat = send.reshape((-1,) + send.shape[2:])
        sent = flat[route.send_idx.numpy()]
        outgoing.append(np.split(sent, np.cumsum(route.send_splits)[:-1]))
    recvs = []
    for me, route in enumerate(routes):
        arrived = np.concatenate([outgoing[p][me] for p in range(procs)])
        recvs.append(arrived[route.place.numpy()].reshape(sends[me].shape))
    return recvs


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("procs", [2, 4, 8])
def test_push_indices_match_the_flat_route(procs, rounds):
    """Each round of the push lands where the flat move puts it, and so
    does the plain push built on the same indices."""
    import torch

    from sparkrdma_tpu_torch.exchange.ring import (push_targets,
                                                   ring_push_plain)

    local = D // procs
    # chunk ids: process p's chunk (l, r, d) is ((p*L + l)*R + r)*D + d
    ids = [np.arange(local * rounds * D).reshape(local, rounds, D)
           + p * local * rounds * D for p in range(procs)]
    windows = [np.full(local * rounds * D, -1) for _ in range(procs)]
    for p in range(procs):
        peer, index = push_targets(p, procs, local, rounds)
        assert len(peer) == len(index) == local * rounds * D
        for q in range(procs):
            windows[q][index[peer == q]] = ids[p].reshape(-1)[peer == q]
    for q in range(procs):
        assert (windows[q] >= 0).all()          # every chunk written once
        assert len(set(windows[q].tolist())) == len(windows[q])
    for r in range(rounds):
        routed = _routed([i[:, r] for i in ids], procs)
        for q in range(procs):
            np.testing.assert_array_equal(
                windows[q].reshape(local, rounds, D)[:, r], routed[q])
    # the plain push, on words, into flat int32 views
    chunk = 5
    sends = [_send(100 * procs + p, local, rounds, chunk)
             for p in range(procs)]
    views = [torch.full((local * rounds * D * chunk + 7,), -1,
                        dtype=torch.int32) for _ in range(procs)]
    for p, send in enumerate(sends):
        ring_push_plain(torch.from_numpy(send), views, p)
    for q in range(procs):
        got = views[q][:local * rounds * D * chunk].numpy()
        np.testing.assert_array_equal(
            got.reshape(local, rounds, D, chunk), _expected(sends, q))
        assert (views[q][-7:] == -1).all()


def test_push_form_with_one_process_is_the_stacked_kernel():
    """P = 1: the push's indices are the stacked permutation's."""
    from sparkrdma_tpu_torch.exchange.ring import push_targets

    peer, index = push_targets(0, 1, D, 2)
    c = np.arange(D * 2 * D)
    s, r, d = c // (2 * D), (c // D) % 2, c % D
    assert (peer == 0).all()
    np.testing.assert_array_equal(index, (d * 2 + r) * D + s)


def test_window_table_holds_eight_processes():
    from sparkrdma_tpu_torch.exchange.windows import RingWindow
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    with pytest.raises(ValueError, match="8 processes"):
        RingWindow(WORLD, "cpu", 0, 9)


class _FakeScope:
    """A scope of two processes played by one: gathers give every rank
    this process's tensor; barriers return at once."""

    name = "fake"

    def all_gather(self, outs, t):
        for o in outs:
            o.copy_(t)

    def barrier(self):
        pass


class _FakeLib:
    """The window calls of ``csrc/ring_exchange.cu``, each returning the
    error code given for it (0 elsewhere; only at its ``nth`` call when
    that is given), each pointer made up and new."""

    def __init__(self, nth=None, **errors):
        self.errors, self.nth, self.calls = errors, nth, []
        self.made, self.freed, self.closed = [], [], []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            if name in ("sr_window_alloc", "sr_ipc_open"):
                args[-1]._obj.value = (len(self.made) + 1) << 20
                self.made.append(args[-1]._obj.value)
            if name == "sr_window_free":
                self.freed.append(args[1].value)
            if name == "sr_ipc_close":
                self.closed.append(args[1].value)
            if self.nth is not None and self.calls.count(name) != self.nth:
                return 0
            return self.errors.get(name, 0)
        return call


#: the calls that undo a window after each failing call: nothing opened
#: yet, so only the own allocation is freed (none where it failed)
_UNDO = {"sr_window_alloc": [], "sr_ipc_export": ["sr_window_free"],
         "sr_ipc_open": ["sr_window_free"]}


@pytest.mark.parametrize("failing", ["sr_window_alloc", "sr_ipc_export",
                                     "sr_ipc_open"])
def test_failed_window_call_raises(monkeypatch, failing):
    """On the card a window call that fails raises ``WindowError`` naming
    it: no move goes on without its windows, and nothing falls back.
    What the failed mapping made is undone."""
    from sparkrdma_tpu_torch import _build
    from sparkrdma_tpu_torch.exchange import windows

    lib = _FakeLib(**{failing: 201})
    monkeypatch.setattr(_build, "library", lambda name: lib)
    win = windows.RingWindow(_FakeScope(), "cuda:0", 0, 2)
    with pytest.raises(windows.WindowError, match=failing):
        win.ensure(4096)
    at = lib.calls.index(failing)
    assert lib.calls[at + 1:] == _UNDO[failing]
    assert win.nbytes == 0 and win.bases() == [] and win.handles == []


def test_failed_open_undoes_the_window(monkeypatch):
    """An open that fails after another peer's was opened closes that
    mapping, frees this process's window and drops it from the registry:
    the next move maps a window of its own, with one base a process in
    rank order, not the first attempt's pointers."""
    import torch

    from sparkrdma_tpu_torch import _build
    from sparkrdma_tpu_torch.exchange import windows

    lib = _FakeLib(nth=2, sr_ipc_open=201)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(windows, "_card_words", lambda ptr, words, dev:
                        torch.full((words,), ptr, dtype=torch.int64))
    scope = _FakeScope()
    win = windows.window_for(scope, "cuda:0", 0, 3)
    with pytest.raises(windows.WindowError, match="sr_ipc_open"):
        win.ensure(4096)
    own, opened = lib.made[:2]
    assert lib.closed == [opened] and lib.freed == [own]
    assert win.nbytes == 0 and win.bases() == [] and win.views() == []
    assert win not in windows.open_windows()
    again = windows.window_for(scope, "cuda:0", 0, 3)
    assert again is not win
    again.ensure(4096)
    try:
        assert again.bases() == lib.made[3:6]     # own, peer 1, peer 2
        assert [int(v[0]) for v in again.views()] == lib.made[3:6]
        assert again.nbytes == windows.GRAIN
    finally:
        windows.close_scope(scope)
    assert lib.closed == [opened] + lib.made[4:6]
    assert lib.freed == [own, lib.made[3]]


# --- the worker -----------------------------------------------------------
def _shm_exists(handle: str) -> bool:
    return os.path.exists(f"/dev/shm/{handle}")


def _names(win) -> list:
    return [bytes(h).rstrip(b"\0").decode() for h in win.handles]


def growth_and_close(rt) -> dict:
    """A small move (the window maps), a larger one (it grows), then
    the scope closes."""
    import torch

    from sparkrdma_tpu_torch.exchange.ring import make_ring_exchange
    from sparkrdma_tpu_torch.exchange.windows import (GRAIN, close_scope,
                                                      open_windows)
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    res = {"grain": GRAIN}
    rank, local = rt.process_index, rt.local_partitions
    # the second move needs twice the first's window
    grow = 2 * GRAIN // (local * 2 * D * 4)
    for step, (rounds, chunk) in enumerate([(1, 3), (2, grow)]):
        sends = [_send(1000 + 10 * step + p, local, rounds, chunk)
                 for p in range(rt.process_count)]
        ex = make_ring_exchange(D, rounds, runtime=rt)
        got = ex(torch.from_numpy(sends[rank])).numpy().copy()
        ex.release()
        (win,) = open_windows()
        res[f"step{step}"] = {
            "equal": bool(np.array_equal(got, _expected(sends, rank))),
            "nbytes": win.nbytes, "growths": win.growths,
            "names": _names(win),
            "exist": [_shm_exists(n) for n in _names(win)]}
    before = res["step1"]["names"]
    old = res["step0"]["names"][rank]
    res["old_unlinked"] = not _shm_exists(old)
    close_scope(WORLD)
    res["closed"] = not open_windows()
    # the peers unlink theirs after the same barrier
    torch.distributed.barrier()
    res["unlinked_after_close"] = not any(_shm_exists(n) for n in before)
    return res


def slow_consumer(rt) -> dict:
    """``MOVES`` moves of different data back to back; process 0 sleeps
    before it reads each move's window."""
    import torch

    from sparkrdma_tpu_torch.exchange.ring import make_ring_exchange
    from sparkrdma_tpu_torch.exchange.windows import close_scope
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    rank, local = rt.process_index, rt.local_partitions
    ex = make_ring_exchange(D, 2, runtime=rt)
    equal = []
    for i in range(MOVES):
        sends = [_send(2000 + 10 * i + p, local, 2, 33)
                 for p in range(rt.process_count)]
        view = ex(torch.from_numpy(sends[rank]))
        if rank == 0:
            time.sleep(SLOW_S)
        equal.append(bool(np.array_equal(view.numpy(),
                                          _expected(sends, rank))))
        ex.release()
    close_scope(WORLD)
    return {"equal": equal}


def sessions(rt, rank: int) -> dict:
    """Two tenants' sessions of one service, each in its thread at once:
    ``SESSION_MOVES`` raw moves in the session's scope, then a shuffle
    read on the ring; each session's window handles."""
    import torch

    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.exchange.ring import make_ring_exchange
    from sparkrdma_tpu_torch.exchange.windows import window_for
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.service import ShuffleService

    svc = ShuffleService(conf=ShuffleConf(slot_records=64,
                                          transport="pallas_ring"),
                         device="cpu")
    res, errors = {}, []
    start = threading.Barrier(len(TENANTS))

    def run(tenant, seed):
        try:
            m = svc.open_session(tenant)
            start.wait(timeout=WORKER_S)
            local = m.runtime.local_partitions
            ex = make_ring_exchange(D, 1, runtime=m.runtime,
                                    coll=m.collectives)
            equal = []
            for i in range(SESSION_MOVES):
                sends = [_send(seed * 100 + 10 * i + p, local, 1, 9)
                         for p in range(m.runtime.process_count)]
                got = ex(torch.from_numpy(sends[rank])).numpy().copy()
                ex.release()
                equal.append(bool(np.array_equal(got,
                                                 _expected(sends, rank))))
            h = m.register_shuffle(1, 16, hash_partitioner(16))
            m.get_writer(h).write(m.runtime.shard_records(
                _tenant_rows(seed))).stop()
            out, totals = m.get_reader(h).read()
            win = window_for(m.collectives, "cpu", rank,
                             m.runtime.process_count)
            res[tenant] = {"equal": equal, "out": records_from_torch(out),
                           "totals": totals.numpy(), "names": _names(win),
                           "moves": win.moves,
                           "scope": m.collectives.name}
            svc.close_session(m)
        except Exception as e:           # surfaced below, not swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in TENANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WORKER_S)
    assert not any(t.is_alive() for t in threads), "a session thread hung"
    assert not errors, errors
    svc.stop()
    return res


def _tenant_rows(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, 2**32, size=(D * PER, 4), dtype=np.uint32)


def _fault_rows() -> np.ndarray:
    return np.random.default_rng(31).integers(1, 2**32, size=(D * 40, 4),
                                              dtype=np.uint32)


#: (name, knobs): the fused regime faulted at dispatch, the streaming one
#: at its first chunk; ``fault_spec`` fires alike in every process
FAULTS = {
    "dispatch": dict(slot_records=64,
                     fault_spec="exchange.dispatch:fail@attempt<1"),
    "stream_round": dict(slot_records=4, max_rounds_in_flight=1,
                         fault_spec="exchange.stream_round:fail@attempt<1"),
}


def faulted_reads(rt_device: str) -> dict:
    """Each of ``FAULTS`` on the ring, and the same read without the
    fault: outputs and the plane's injection counts."""
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.interop import records_from_torch

    res = {}
    for name, knobs in FAULTS.items():
        for faulted in (True, False):
            kw = dict(knobs)
            if not faulted:
                kw.pop("fault_spec")
            m = ShuffleManager(MeshRuntime(ShuffleConf(
                transport="pallas_ring", max_retry_attempts=3,
                retry_backoff_ms=1, **kw), num_partitions=D,
                device=rt_device))
            h = m.register_shuffle(2, 16, hash_partitioner(16))
            m.get_writer(h).write(m.runtime.shard_records(
                _fault_rows())).stop()
            out, totals = m.get_reader(h).read()
            tag = f"{name}/{'faulted' if faulted else 'clean'}"
            res[tag] = {"out": records_from_torch(out),
                        "totals": totals.numpy(),
                        "injected": m.faults.injected_counts()}
            m.stop()
    return res


def worker(rank: int, world: int, init_file: str, out_dir: str) -> int:
    assert "jax" not in sys.modules
    import torch

    from sparkrdma_tpu_torch import MeshRuntime, initialize_distributed
    from sparkrdma_tpu_torch.exchange.windows import open_windows

    torch.set_num_threads(1)
    assert initialize_distributed(num_processes=world, process_id=rank,
                                  init_method=f"file://{init_file}",
                                  backend="gloo")
    rt = MeshRuntime(num_partitions=D, device="cpu")
    said = {"growth": growth_and_close(rt), "slow": slow_consumer(rt)}
    arrays = {}
    for tenant, r in sessions(rt, rank).items():
        arrays[f"{tenant}/out"] = r.pop("out")
        arrays[f"{tenant}/totals"] = r.pop("totals")
        said[tenant] = r
    for tag, r in faulted_reads("cpu").items():
        arrays[f"{tag}/out"] = r.pop("out")
        arrays[f"{tag}/totals"] = r.pop("totals")
        said[tag] = r
    said["left_open"] = len(open_windows())
    np.savez(os.path.join(out_dir, f"proc{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"said{rank}.json"), "w") as f:
        json.dump(said, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MPOK proc={rank}", flush=True)
    return 0


# --- the test side --------------------------------------------------------
def _run_workers(tmp, world: int) -> list:
    """``world`` workers' ``(arrays, what they said)``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(tmp / "rendezvous"), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"workers ran past {WORKER_S} s:\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out}"
        assert f"MPOK proc={r}" in out, out
    return [(dict(np.load(tmp / f"proc{r}.npz")),
             json.loads((tmp / f"said{r}.json").read_text()))
            for r in range(world)]


@pytest.fixture(scope="module")
def workers(tmp_path_factory) -> list:
    """The two processes' ``(arrays, what they said)``."""
    return _run_workers(tmp_path_factory.mktemp("ring_windows"), 2)


def _joined(workers, key):
    axis = 1 if key.endswith("/out") else 0
    return np.concatenate([a[key] for a, _ in workers], axis=axis)


def _check_growth(workers) -> None:
    for _, said in workers:
        g = said["growth"]
        small, large = g["step0"], g["step1"]
        assert small["equal"] and large["equal"]
        assert (small["nbytes"], small["growths"]) == (g["grain"], 1)
        assert large["nbytes"] == 2 * g["grain"] and large["growths"] == 2
        assert all(small["exist"]) and all(large["exist"])
        assert set(small["names"]).isdisjoint(large["names"])
        assert g["old_unlinked"]
        assert g["closed"] and g["unlinked_after_close"]
    # every process gathered the same handles
    for _, said in workers[1:]:
        assert said["growth"]["step1"]["names"] == \
            workers[0][1]["growth"]["step1"]["names"]


def test_window_grows_and_closes(workers):
    _check_growth(workers)


def test_slow_consumer_never_reads_the_next_move(workers):
    for _, said in workers:
        assert said["slow"]["equal"] == [True] * MOVES


@pytest.fixture(scope="module")
def solo_reads() -> dict:
    """Each tenant's shuffle read on the ring in one process."""
    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.service import ShuffleService

    svc = ShuffleService(conf=ShuffleConf(slot_records=64,
                                          transport="pallas_ring"),
                         device="cpu")
    res = {}
    try:
        for tenant, seed in TENANTS.items():
            m = svc.open_session(tenant)
            h = m.register_shuffle(1, 16, hash_partitioner(16))
            m.get_writer(h).write(m.runtime.shard_records(
                _tenant_rows(seed))).stop()
            out, totals = m.get_reader(h).read()
            res[tenant] = (records_from_torch(out), totals.numpy())
            svc.close_session(m)
    finally:
        svc.stop()
    return res


def _check_sessions(workers, solo_reads) -> None:
    for _, said in workers:
        names = {t: said[t]["names"] for t in TENANTS}
        assert set(names["alice"]).isdisjoint(names["bob"])
        assert said["alice"]["scope"] != said["bob"]["scope"]
        for t in TENANTS:
            assert said[t]["equal"] == [True] * SESSION_MOVES
            assert said[t]["moves"] > SESSION_MOVES
        assert said["left_open"] == 0
    for t in TENANTS:
        # each process's session saw its peers' handles in the same scope
        for _, said in workers[1:]:
            assert said[t]["names"] == workers[0][1][t]["names"]
        np.testing.assert_array_equal(_joined(workers, f"{t}/out"),
                                      solo_reads[t][0])
        np.testing.assert_array_equal(_joined(workers, f"{t}/totals"),
                                      solo_reads[t][1])


def test_sessions_windows_stay_apart(workers, solo_reads):
    _check_sessions(workers, solo_reads)


def _check_fault(workers, name) -> None:
    site = "exchange.dispatch" if name == "dispatch" else \
        "exchange.stream_round"
    for _, said in workers:
        assert said[f"{name}/faulted"]["injected"] == {site: {"fail": 1}}
        assert said[f"{name}/clean"]["injected"] == {}
    for key in ("out", "totals"):
        np.testing.assert_array_equal(
            _joined(workers, f"{name}/faulted/{key}"),
            _joined(workers, f"{name}/clean/{key}"))


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_on_every_process_is_retried(workers, name):
    _check_fault(workers, name)


@pytest.mark.slow
def test_four_processes(tmp_path, solo_reads):
    """Every scenario again over four processes of 2 partitions."""
    four = _run_workers(tmp_path, 4)
    _check_growth(four)
    for _, said in four:
        assert said["slow"]["equal"] == [True] * MOVES
    _check_sessions(four, solo_reads)
    for name in FAULTS:
        _check_fault(four, name)


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
