"""The shuffle service across processes: two gloo CPU processes x 4
partitions, each with its own ``ShuffleService`` over one group.

The worker-as-script pattern of ``tests/test_torch_distributed_dataset.py``
(``python tests/test_torch_distributed_service.py RANK WORLD INIT_FILE
OUT_DIR``, no JAX, each killed past 120 s). In each worker:

- two tenant threads at once (``admission_slots=0``), three TeraSorts
  each, in a session each: every read, joined over the processes, equals
  that tenant's TeraSort run alone in one process, which equals the
  reference's (handed the port's splitter sample). Each session has its
  own collective scope, so no collective of one tenant pairs with the
  other's;
- two sessions opened in opposite orders in the two processes, then
  used in one order: they pair by name (tenant and count), not by the
  order they were opened in;
- an RPC client in each process: ``write`` runs its exchange, ``read``
  refuses (the reference's ``sparkrdma_tpu/service/rpc.py:478``), and
  ``resume_read`` answers as it does in one process;
- a service with ``admission_slots > 0`` refuses at construction (each
  process would admit tenants in its own order).

The refusals hold on a runtime that believes it is process 0 of 2 too,
and in one process no scope is made.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
D = 8
WORKER_S = 120
#: the merge-path geometry, as ``tests/test_torch_distributed_dataset.py``
KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
             pack_sort_min_payload=0, wide_sort_min_payload=0)
PER = 160
READS = 3
TENANTS = {"alice": 11, "bob": 12}
THREAD_S = 90
RPC_SID = 3
RPC_READ_LINE = "sparkrdma_tpu/service/rpc.py:478"
ADMISSION_LINE = "sparkrdma_tpu/service/admission.py:79"


def tenant_rows(seed: int) -> np.ndarray:
    """A tenant's TeraSort input, ``uint32[D * PER, 4]``."""
    return np.random.default_rng(seed).integers(
        0, 2**32 - 1, size=(D * PER, 4), dtype=np.uint32)


def _u32(t) -> np.ndarray:
    from sparkrdma_tpu_torch.interop import records_from_torch

    return records_from_torch(t)


def port_terasort(m, seed: int, sid: int) -> tuple:
    """The tenant's TeraSort on session ``m`` (this process's rows):
    ``(out, totals)``."""
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    _, out, totals = run_terasort(
        m, PER, verify=False, warmup=False, shuffle_id=sid,
        input_records=m.runtime.shard_records(tenant_rows(seed)))
    return _u32(out), totals.cpu().numpy().astype(np.int64)


def sampled_terasort(m, seed: int, sid: int) -> tuple:
    """:func:`port_terasort` and the splitter sample it drew (one thread
    only: it patches the module)."""
    from sparkrdma_tpu_torch.workloads import terasort as terasort_mod

    plain = terasort_mod.make_sampler
    drawn = []

    def recording(*a, **kw):
        fn = plain(*a, **kw)
        return lambda records: drawn.append(fn(records)) or drawn[-1]

    terasort_mod.make_sampler = recording
    try:
        return port_terasort(m, seed, sid) + (drawn[0],)
    finally:
        terasort_mod.make_sampler = plain


def _svc(**kw):
    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.service import ShuffleService

    return ShuffleService(conf=ShuffleConf(**KNOBS, **kw), device="cpu")


def concurrent_tenants(svc) -> dict:
    """Each tenant in its own thread, all at once: a session, then
    ``READS`` TeraSorts; ``{tenant: [(out, totals), ...]}``."""
    results, errors = {}, []
    start = threading.Barrier(len(TENANTS))

    def run(tenant, seed):
        try:
            m = svc.open_session(tenant)
            start.wait(timeout=THREAD_S)
            results[tenant] = [port_terasort(m, seed, 10 + i)
                               for i in range(READS)]
            svc.close_session(m)
        except Exception as e:           # surfaced below, not swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in TENANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=THREAD_S)
    assert not any(t.is_alive() for t in threads), "a tenant thread hung"
    assert not errors, errors
    return results


def crossed_sessions(svc, rank: int) -> dict:
    """Sessions opened in opposite orders in the two processes, then
    used in one order: ``{tenant: (out, totals)}``."""
    order = list(TENANTS) if rank % 2 == 0 else list(TENANTS)[::-1]
    sessions = {t: svc.open_session(f"crossed-{t}") for t in order}
    res = {t: port_terasort(sessions[t], seed, 30)
           for t, seed in TENANTS.items()}
    for m in sessions.values():
        svc.close_session(m)
    return res


def rpc_calls(root: str, rank: int = 0) -> dict:
    """A client of this process's daemon: ``write``, then ``read`` and
    ``resume_read``; what each said."""
    from sparkrdma_tpu_torch.service.client import RpcCallError, RpcClient

    svc = _svc(rpc_port=0, spill_dir=root)
    said = {}
    try:
        c = RpcClient(port=svc.rpc.port, client_id=f"c{rank}")
        c.hello()
        s = c.open_session("rpc")
        c.register_shuffle(s, RPC_SID, 0)
        said["write"] = c.write(s, RPC_SID, tenant_rows(7).tolist())
        for op in ("read", "resume_read"):
            try:
                getattr(c, op)(s, RPC_SID)
                said[op] = ""
            except RpcCallError as e:
                said[op] = str(e)
        c.close()
    finally:
        svc.stop()
    return said


def admission_refusal() -> list:
    try:
        _svc(admission_slots=1).stop()
        return ["", ""]
    except Exception as e:          # the test holds type and message
        return [type(e).__name__, str(e)]


def worker(rank: int, world: int, init_file: str, out_dir: str) -> int:
    assert "jax" not in sys.modules
    import torch

    from sparkrdma_tpu_torch import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed(num_processes=world, process_id=rank,
                                  init_method=f"file://{init_file}",
                                  backend="gloo")
    res = {}
    svc = _svc()
    for tenant, reads in concurrent_tenants(svc).items():
        for i, (out, tot) in enumerate(reads):
            res[f"{tenant}/{i}/out"], res[f"{tenant}/{i}/totals"] = out, tot
    for tenant, (out, tot) in crossed_sessions(svc, rank).items():
        res[f"{tenant}/crossed/out"], res[f"{tenant}/crossed/totals"] = \
            out, tot
    svc.stop()
    np.savez(os.path.join(out_dir, f"proc{rank}.npz"), **res)
    said = {"rpc": rpc_calls(os.path.join(out_dir, f"spill{rank}"), rank),
            "admission": admission_refusal()}
    with open(os.path.join(out_dir, f"said{rank}.json"), "w") as f:
        json.dump(said, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules
    print(f"MPOK proc={rank}", flush=True)
    return 0


# --- the test side -----------------------------------------------------
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
    return _run_workers(tmp_path_factory.mktemp("two"), 2)


@pytest.fixture(scope="module")
def solo() -> dict:
    """Each tenant's TeraSort alone, in one process, in a service
    session: ``{tenant: (out, totals, sample)}``."""
    svc = _svc()
    res = {}
    for tenant, seed in TENANTS.items():
        m = svc.open_session(tenant)
        res[tenant] = sampled_terasort(m, seed, 1)
        svc.close_session(m)
    svc.stop()
    return res


def _reference_terasort(seed: int, sample: np.ndarray):
    from sparkrdma_tpu import ShuffleConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu.workloads import terasort as terasort_mod

    plain = terasort_mod.make_sampler
    terasort_mod.make_sampler = lambda *a, **k: (lambda records: sample)
    m = ShuffleManager(conf=ShuffleConf(**KNOBS))
    try:
        _, out, totals = terasort_mod.run_terasort(
            m, PER, verify=False, warmup=False, shuffle_id=1,
            input_records=m.runtime.shard_records(tenant_rows(seed)))
        return np.asarray(out), np.asarray(totals).astype(np.int64)
    finally:
        terasort_mod.make_sampler = plain
        m.stop()


def _joined(workers, key):
    parts = [w[0][key] for w in workers]
    return np.concatenate(parts, axis=1 if key.endswith("/out") else 0)


@pytest.mark.parametrize("tenant", list(TENANTS))
def test_solo_equals_the_reference(solo, tenant):
    out, totals, sample = solo[tenant]
    ref_out, ref_totals = _reference_terasort(TENANTS[tenant], sample)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(totals, ref_totals)
    cap = out.shape[1] // D      # the merge-path geometry
    assert cap & (cap - 1) == 0 and cap >= 2 * KNOBS["fast_sort_run"]
    assert int(totals.sum()) == D * PER


@pytest.mark.parametrize("read", range(READS))
@pytest.mark.parametrize("tenant", list(TENANTS))
def test_concurrent_tenants_each_get_their_solo_output(workers, solo,
                                                       tenant, read):
    np.testing.assert_array_equal(
        _joined(workers, f"{tenant}/{read}/out"), solo[tenant][0])
    np.testing.assert_array_equal(
        _joined(workers, f"{tenant}/{read}/totals"), solo[tenant][1])


@pytest.mark.parametrize("tenant", list(TENANTS))
def test_sessions_opened_in_other_orders_pair_by_name(workers, solo,
                                                      tenant):
    np.testing.assert_array_equal(
        _joined(workers, f"{tenant}/crossed/out"), solo[tenant][0])
    np.testing.assert_array_equal(
        _joined(workers, f"{tenant}/crossed/totals"), solo[tenant][1])


@pytest.mark.slow
def test_four_processes_tenants_get_their_solo_output(tmp_path, solo):
    """Four processes of two partitions each, sessions crossed between
    even and odd ranks: every read is still the tenant's own."""
    workers = _run_workers(tmp_path, 4)
    for tenant in TENANTS:
        for read in [str(i) for i in range(READS)] + ["crossed"]:
            np.testing.assert_array_equal(
                _joined(workers, f"{tenant}/{read}/out"), solo[tenant][0])
            np.testing.assert_array_equal(
                _joined(workers, f"{tenant}/{read}/totals"), solo[tenant][1])


def test_rpc_write_runs_and_read_refuses(workers, tmp_path):
    one = rpc_calls(str(tmp_path / "spill"))
    assert one["read"] == ""           # one process: the read runs
    for _, said in workers:
        rpc = said["rpc"]
        assert rpc["write"] == D * PER
        assert "NotImplementedError" in rpc["read"]
        assert "A.12" in rpc["read"] and f"`{RPC_READ_LINE}`" in rpc["read"]
        # nothing was checkpointed: the reply one process gives
        assert rpc["resume_read"].split(" under ")[0] == \
            one["resume_read"].split(" under ")[0]
        assert "no segment checkpoint for shuffle" in rpc["resume_read"]


def test_admission_slots_refused_in_the_group(workers):
    for _, said in workers:
        kind, msg = said["admission"]
        assert kind == "NotImplementedError", said["admission"]
        assert "A.12" in msg and f"`{ADMISSION_LINE}`" in msg
        assert "own order" in msg


# --- on a runtime that believes it is process 0 of 2 -------------------
@pytest.fixture
def two_processes(monkeypatch):
    from sparkrdma_tpu_torch.runtime import distributed, mesh

    monkeypatch.setattr(mesh, "group_rank", lambda: (0, 2))
    monkeypatch.setattr(distributed, "group_rank", lambda: (0, 2))


def test_admission_slots_refused_across_processes(two_processes):
    with pytest.raises(NotImplementedError, match="A.12") as err:
        _svc(admission_slots=2)
    assert f"as the reference: `{ADMISSION_LINE}`" in str(err.value)


def test_service_runs_across_processes(two_processes):
    """The daemon and its sessions are no longer refused; each session
    gets a scope keyed by tenant and count, made without connecting."""
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    svc = _svc()
    try:
        a1, b1, a2 = (svc.open_session(t) for t in ("ta", "tb", "ta"))
        names = [m.collectives.name for m in (a1, b1, a2)]
        assert names == ["ta#1", "tb#1", "ta#2"]
        assert all(m.collectives is not WORLD for m in (a1, b1, a2))
        assert a1._exchange.collectives is a1.collectives
    finally:
        svc.stop()


def test_rpc_read_refused_across_processes(two_processes, tmp_path):
    from sparkrdma_tpu_torch.service.client import RpcCallError, RpcClient

    svc = _svc(rpc_port=0)
    try:
        with RpcClient(port=svc.rpc.port, client_id="c") as c:
            c.hello()
            s = c.open_session("rpc")
            c.register_shuffle(s, RPC_SID, 0)
            with pytest.raises(RpcCallError, match="A.12") as err:
                c.read(s, RPC_SID)
            assert f"as the reference: `{RPC_READ_LINE}`" in str(err.value)
    finally:
        svc.stop()


def test_one_process_makes_no_scope():
    from sparkrdma_tpu_torch.runtime.distributed import WORLD

    svc = _svc()
    try:
        m = svc.open_session("solo-scope")
        assert m.collectives is WORLD and m._exchange.collectives is WORLD
    finally:
        svc.stop()


def test_scope_names_count_per_key():
    """Each ask of a key gets a name of its own, counted per key."""
    from sparkrdma_tpu_torch.runtime.distributed import collective_scope

    names = [collective_scope(k).name for k in ("kx", "ky", "kx")]
    assert names == ["kx#1", "ky#1", "kx#2"]


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                    sys.argv[4]))
