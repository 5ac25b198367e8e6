#!/usr/bin/env python3
"""Chaos soak of the PyTorch port: the real workloads under a randomized
multi-site fault schedule, proved bit-identical against a fault-free
control run.

The port's counterpart of ``scripts/chaos_soak.py``: the same passes in
the same order, the same checks, the same JSON summary fields and exit
codes, with the port's managers (``sparkrdma_tpu_torch``) in place of the
reference's. D partitions are stacked on one device (``--partitions``,
on ``--device``), where the reference spreads them over a forced CPU
mesh.

Two passes over the same seeded data, same partitions, same conf
geometry:

1. **Control** — no ``fault_spec``. Captures every leg's output bytes
   (repartition rows+totals, terasort sorted records, join aggregates,
   serde round-trip payload map, checkpoint-resume rows).
2. **Chaos** — the same legs with a ``fault_spec`` injecting transient
   faults at >= 6 distinct sites (exchange dispatch + streaming rounds,
   pool acquire delays, spill write/read, checkpoint read, and — when
   the native codec is built — serde encode). Every fault is transient
   (``attempt<N``), so recovery MUST reproduce the control outputs
   bit for bit; any drift is a correctness bug in the recovery paths.

After the chaos pass the soak audits the books: the fault plane's
``fail``/``corrupt`` injection tally must equal the journal's summed
``retry_count`` plus the recovery and degradation totals — every
injected fault is accounted for by exactly one retry, one in-place
recovery, or one degradation (``delay`` injections only slow things
down and are excluded). Spans with retries must carry per-attempt
``backoff_ms`` entries (journal schema v5). The port's recoveries are
its own where its contract differs from the reference's (ROADMAP
C.1.13): an injected ``serde.encode`` failure runs the native call again
and books a ``serde_native`` recovery, where the reference degrades to
numpy; either way the rows are the same and the books balance.

The schedule is *randomized* per ``--seed`` (clause order, delay
magnitude, data) but fully deterministic given the seed — a failing
seed replays exactly; the same seed gives the reference's schedule.

3. **Two-tenant blast radius** — one ``ShuffleService``, a *noisy*
   tenant whose session conf carries a fault schedule and a *clean*
   tenant with none, shuffling concurrently. The clean tenant's output
   must be bit-identical to a solo control run through its own service,
   and its journal spans must show zero retries, zero injected-fault
   events and no degradations. The service also runs its wire probe
   (``probe_port=0``) **under fire**: a monitor thread polls
   ``/snapshot`` + ``/journal`` throughout the faulted run, one client
   connects and hangs up mid-response, and afterwards the probe must
   still answer a complete request with zero leaked threads once the
   service stops.

4. **Map-side combine under fire** — a duplicate-heavy
   ``reduce_by_key`` with the pre-exchange combine pass forced ON runs
   under transient faults at ``exchange.dispatch`` (and, when the native
   codec is built, ``serde.encode``); its output must match a fault-free
   ``map_side_combine="off"`` control bit for bit.

5. **Out-of-process RPC pass** — two tenants in SEPARATE OS processes
   (``--rpc-worker`` self-invocations, pure wire clients that never
   touch the device) drive one shared daemon: a *clean* worker with no
   faults and a *noisy* worker whose client-side plane corrupts / fails
   / delays ``rpc.send`` / ``rpc.recv`` frames. Both workers' outputs
   must be bit-identical (sha256 of rows+totals) to solo in-process
   controls, the noisy worker's books must balance, the clean worker
   must see zero injections and zero retries, and the daemon must end
   with no leases or sessions left behind.

6. **Alerting end-to-end** — a chaos arm (a 300 ms dispatch delay and a
   starved host spill tier) must make the live ``AlertEvaluator`` fire
   and journal ``spill_storm`` and ``straggler_spread``, visible at the
   probe's ``/alerts`` AND surfaced by ``scripts/shuffle_report.py
   --doctor`` (the reference's stdlib CLI, over the port's journal); an
   identical fault-free control arm with an ample host tier must fire
   zero alerts.

7. **Planner under fire** — the star-schema suite with every ``plan_*``
   rewrite on under transient ``exchange.dispatch`` faults, against a
   fault-free control with every knob off: the same grouped sums.

Usage::

    python scripts/torch_chaos_soak.py --seed 7                  # the card
    python scripts/torch_chaos_soak.py --device cpu --seed 7     # no card
    python scripts/torch_chaos_soak.py --transport pallas_ring \\
        --records-per-device 65536 --seed 7    # the ring kernel replays

Exit 0: all legs bit-identical, >= 6 sites hit, books balanced, and
every pass ``ok``; 1 otherwise. Prints one JSON summary line (plus
per-leg progress on stderr): the reference's fields, and the device and
the transport it ran on.
"""

import argparse
import json
import os
import random
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_spec(rng: random.Random, include_serde: bool) -> str:
    """Randomized-but-deterministic schedule hitting >= 6 distinct sites.

    Every clause is transient (bounded ``attempt<N``), so the run must
    converge to the control output; the randomness is in clause order,
    the injected acquire delay, and (via ``--seed``) the data itself.
    """
    clauses = [
        "exchange.dispatch:fail@attempt<2",
        "exchange.stream_round:fail@attempt<1",
        f"pool.acquire:delay={rng.choice((1, 2, 5))}ms@attempt<4",
        "spill.write:fail@attempt<1",
        "spill.read:corrupt@attempt<1",
        "checkpoint.read:fail@attempt<1",
    ]
    if include_serde:
        clauses.append("serde.encode:fail@attempt<1")
    rng.shuffle(clauses)   # order is cosmetic: sites are distinct
    return ";".join(clauses)


def host_pair(rows, totals):
    """A read's (rows, totals) on the host: ``uint32`` columns and
    ``int64`` totals, comparable bit for bit."""
    import numpy as np

    from sparkrdma_tpu_torch.interop import records_from_torch

    return (records_from_torch(rows).copy(),
            totals.detach().cpu().numpy().astype(np.int64))


def new_manager(conf, args):
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    return ShuffleManager(MeshRuntime(conf, args.partitions,
                                      device=args.device), conf)


def new_service(conf, args):
    from sparkrdma_tpu_torch.service import ShuffleService

    return ShuffleService(conf=conf, num_partitions=args.partitions,
                          device=args.device)


def run_legs(m, seed: int, records_per_device: int) -> dict:
    """All soak legs on one manager; returns {leg: host-comparable output}.

    Ordering matters only for determinism of fault-hit placement: the
    repartition leg runs first (absorbing the dispatch/stream-round
    faults and acquire delays), the resume leg runs last (first
    ``read_array`` of the run, absorbing the checkpoint-read fail and
    spill-read corruption inside one bounded ``_checked_read``).
    """
    import numpy as np

    from sparkrdma_tpu_torch.api.dataset import Dataset
    from sparkrdma_tpu_torch.api.serde import (decode_bytes_rows,
                                               encode_bytes_rows)
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads.join import run_hash_join
    from sparkrdma_tpu_torch.workloads.terasort import run_terasort

    rt = m.runtime
    mesh = rt.num_partitions
    w = m.conf.record_words
    rng = np.random.default_rng(seed)
    out: dict = {}

    # --- leg 1: repartition (raw output rows, not just a verified bit) --
    x = rng.integers(0, 2**32, size=(mesh * records_per_device, w),
                     dtype=np.uint32)
    part = hash_partitioner(mesh, m.conf.key_words)
    h = m.register_shuffle(1, mesh, part)
    try:
        m.get_writer(h).write(rt.shard_records(x)).stop(True)
        out["repartition"] = host_pair(*m.get_reader(h).read())
    finally:
        m.unregister_shuffle(1)
    print("  leg repartition done", file=sys.stderr, flush=True)

    # --- leg 2: terasort (globally sorted records) ----------------------
    # the reference's run_terasort draws its records from numpy's
    # generator at seed + 1, the port's from torch's: hand it numpy's,
    # so both soaks sort the same data
    x2 = np.random.default_rng(seed + 1).integers(
        0, 2**32, size=(mesh * records_per_device, w), dtype=np.uint32)
    _, srt, stot = run_terasort(m, records_per_device=records_per_device,
                                seed=seed + 1, shuffle_id=2,
                                verify=False, warmup=False,
                                input_records=rt.shard_records(x2))
    out["terasort"] = host_pair(srt, stot)
    print("  leg terasort done", file=sys.stderr, flush=True)

    # --- leg 3: hash join (exact aggregate outputs) ---------------------
    j = run_hash_join(m, rows_per_device_a=records_per_device // 2,
                      rows_per_device_b=records_per_device // 2,
                      seed=seed + 2, shuffle_ids=(3, 4), verify=False)
    out["join"] = (int(j.matches), float(j.sum_products))
    print("  leg join done", file=sys.stderr, flush=True)

    # --- leg 4: serde-encoded shuffle (byte payload round-trip) ---------
    n = mesh * max(records_per_device // 4, 64)
    keys = rng.integers(0, 2**31, size=(n, 2), dtype=np.uint32)
    lens = rng.integers(0, 25, size=n)
    payloads = [bytes(rng.integers(0, 256, size=int(ln), dtype=np.uint8))
                for ln in lens]
    rows_enc = encode_bytes_rows(keys, payloads, 24)
    back = Dataset.from_host_rows(m, rows_enc).repartition().to_host_rows()
    k2, p2 = decode_bytes_rows(back, 2)
    out["serde"] = {tuple(map(int, k2[i])): p2[i] for i in range(len(p2))}
    print("  leg serde done", file=sys.stderr, flush=True)

    # --- leg 5: checkpoint resume (kill the live map output, reload) ----
    x5 = rng.integers(0, 2**32, size=(mesh * records_per_device, w),
                      dtype=np.uint32)
    h5 = m.register_shuffle(5, mesh, part)
    try:
        m.get_writer(h5).write(rt.shard_records(x5)).stop(True)
        m._writers[5]._records = None     # executor loss: host copy only
        m.resume_shuffle(h5)              # checkpoint.read / spill.read
        out["resume"] = host_pair(*m.get_reader(h5).read())
    finally:
        m.unregister_shuffle(5)
    print("  leg resume done", file=sys.stderr, flush=True)
    return out


def run_service_tenant_leg(svc, tenant, conf, seed, records_per_device,
                           shuffle_id):
    """One tenant's repartition through a shared ShuffleService.

    Returns ``(output, sites_hit)`` where output is the host-side
    (rows, totals) pair — deterministic given (seed, partitions), so
    comparable bit-for-bit across service instances — and sites_hit is
    the session fault plane's hit set (empty for a clean tenant).
    """
    import numpy as np

    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner

    m = svc.open_session(tenant, conf)
    try:
        rt = m.runtime
        mesh = rt.num_partitions
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 2**32,
                         size=(mesh * records_per_device,
                               m.conf.record_words),
                         dtype=np.uint32)
        part = hash_partitioner(mesh, m.conf.key_words)
        h = m.register_shuffle(shuffle_id, mesh, part)
        try:
            m.get_writer(h).write(rt.shard_records(x)).stop(True)
            out = host_pair(*m.get_reader(h).read())
        finally:
            m.unregister_shuffle(shuffle_id)
        return out, sorted(m.faults.sites_hit())
    finally:
        svc.close_session(m)


def probe_fetch(port: int, path: str, timeout: float = 5.0):
    """One request over the probe's newline wire format (send
    ``GET <path>\\n``, read to EOF) -> decoded JSON body. Raises
    OSError/ValueError on connection or decode failure."""
    import socket

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.sendall(f"GET {path}\n".encode("ascii"))
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode("utf-8"))


def run_two_tenant_leg(args, common: dict, tmp: str) -> dict:
    """The blast-radius pass: noisy + clean tenants through one service.

    The noisy tenant's faults are all transient and live entirely in
    its session conf; the clean tenant runs the identical workload it
    ran through a solo control service. Verdict fields:

    - ``clean_identical``: clean output == solo-control output, bitwise
    - ``clean_retries`` / ``clean_fault_events`` / ``clean_degraded``:
      summed over the clean tenant's journal spans — all must be zero
    - ``noisy_sites_hit``: the noisy plane must have actually fired
    - ``probe``: the probe-under-fire verdict — the service's wire
      probe polled throughout the faulted run (``polls_ok > 0``), still
      answering after a client hung up mid-response
      (``post_kill_snapshot_ok``), and no threads outliving the
      service (``leaked_threads`` empty)
    """
    import socket
    import threading

    from sparkrdma_tpu_torch import ShuffleConf

    noisy_spec = ("exchange.dispatch:fail@attempt<2;"
                  "exchange.stream_round:fail@attempt<1;"
                  "pool.acquire:delay=1ms@attempt<4")
    rpd = max(args.records_per_device // 2, 256)

    # --- solo control: the clean tenant alone through its own service --
    conf_solo = ShuffleConf(spill_dir=os.path.join(tmp, "svc_solo"),
                            **common)
    with new_service(conf_solo, args) as svc:
        control, _ = run_service_tenant_leg(
            svc, "clean", None, args.seed + 10, rpd, shuffle_id=12)

    # --- shared service: both tenants concurrently, probe under fire ---
    journal = os.path.join(tmp, "svc_journal.jsonl")
    conf_svc = ShuffleConf(spill_dir=os.path.join(tmp, "svc_duo"),
                           metrics_sink=journal, probe_port=0, **common)
    conf_noisy = ShuffleConf(spill_dir=os.path.join(tmp, "svc_duo"),
                             metrics_sink=journal, fault_spec=noisy_spec,
                             **common)
    results: dict = {}
    errors: list = []

    def tenant_run(name, conf, sid, seed):
        try:
            results[name] = run_service_tenant_leg(
                svc, name, conf, seed, rpd, shuffle_id=sid)
        except Exception as e:   # surfaced in the summary, not lost
            errors.append(f"{name}: {e!r}")

    before_threads = {t.name for t in threading.enumerate()}
    tally = {"polls_ok": 0, "poll_errors": 0}
    stop_evt = threading.Event()
    kill_err = ""
    post_ok = False
    with new_service(conf_svc, args) as svc:
        port = svc.probe.port if svc.probe is not None else -1

        def monitor():
            # poll both JSON surfaces the whole time the tenants run —
            # the probe must serve while faults fire in the data plane
            while not stop_evt.is_set():
                for path in ("/snapshot", "/journal"):
                    try:
                        probe_fetch(port, path)
                        tally["polls_ok"] += 1
                    except (OSError, ValueError):
                        tally["poll_errors"] += 1
                stop_evt.wait(0.02)

        mon = threading.Thread(target=monitor, daemon=True,
                               name="chaos-probe-monitor")
        mon.start()
        threads = [
            threading.Thread(target=tenant_run,
                             args=("noisy", conf_noisy, 11,
                                   args.seed + 20)),
            threading.Thread(target=tenant_run,
                             args=("clean", None, 12, args.seed + 10)),
        ]
        for t in threads:
            t.start()
        # killed client: connect, read one byte, slam the connection
        # shut mid-response while the tenants shuffle under faults
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=5.0) as s:
                s.sendall(b"GET /journal\n")
                s.recv(1)
        except OSError as e:
            kill_err = repr(e)
        for t in threads:
            t.join()
        stop_evt.set()
        mon.join(5.0)
        # the probe must still answer a COMPLETE request after the kill
        try:
            post = probe_fetch(port, "/snapshot")
            post_ok = isinstance(post, dict) and "telemetry" in post
        except (OSError, ValueError):
            post_ok = False
    # service stopped: nothing it started may outlive it
    leaked = sorted({t.name for t in threading.enumerate()}
                    - before_threads - {"chaos-probe-monitor"})
    probe_leg = {
        "ok": (port >= 0 and tally["polls_ok"] > 0 and post_ok
               and not kill_err and not leaked),
        "port": port,
        "polls_ok": tally["polls_ok"],
        "poll_errors": tally["poll_errors"],
        "killed_client_error": kill_err,
        "post_kill_snapshot_ok": post_ok,
        "leaked_threads": leaked,
    }

    clean_spans = [s for s in read_spans(journal)
                   if s.get("tenant") == "clean"]
    clean_retries = sum(int(s.get("retry_count") or 0)
                        for s in clean_spans)
    clean_faults = sum(1 for s in clean_spans
                       for e in (s.get("events") or [])
                       if e.get("name") == "fault:injected")
    clean_degraded = sorted({d for s in clean_spans
                             for d in (s.get("degraded") or [])})
    clean_out = results.get("clean", (None, None))[0]
    noisy_sites = results.get("noisy", (None, []))[1]
    identical = clean_out is not None and outputs_equal(control, clean_out)
    ok = (not errors and identical and bool(clean_spans)
          and clean_retries == 0 and clean_faults == 0
          and not clean_degraded and bool(noisy_sites)
          and probe_leg["ok"])
    return {
        "ok": ok,
        "errors": errors,
        "clean_identical": identical,
        "clean_spans": len(clean_spans),
        "clean_retries": clean_retries,
        "clean_fault_events": clean_faults,
        "clean_degraded": clean_degraded,
        "noisy_sites_hit": noisy_sites,
        "probe": probe_leg,
    }


def outputs_digest(out) -> str:
    """sha256 over the host bytes of a (rows, totals) pair.

    Canonicalized dtypes (rows uint32, totals int64) so an in-process
    control and an RPC worker (JSON nested lists) digest identically iff
    they are bit-identical."""
    import hashlib

    import numpy as np

    rows, totals = out
    d = hashlib.sha256()
    d.update(np.ascontiguousarray(
        np.asarray(rows, dtype=np.uint32)).tobytes())
    d.update(np.ascontiguousarray(
        np.asarray(totals, dtype=np.int64)).tobytes())
    return d.hexdigest()


def rpc_worker_main(args) -> int:
    """Entry for ``--rpc-worker`` subprocesses: one tenant's RPC driver.

    Runs the same seeded repartition as :func:`run_service_tenant_leg`,
    but against a daemon in ANOTHER process over the wire protocol,
    with this process's own fault plane installed (``--rpc-fault-spec``)
    so wire chaos and its books are strictly per-process. A pure client:
    it builds no runtime and touches no device. Prints one ``RPCSOAK
    {json}`` line: the output digest plus this side of the ledger (hard
    injections, client retries, books verdict).
    """
    import numpy as np

    from sparkrdma_tpu_torch import faults
    from sparkrdma_tpu_torch.service.client import RpcClient

    plane = faults.FaultPlane(args.rpc_fault_spec, seed=args.seed)
    if args.rpc_fault_spec:
        faults.set_active_plane(plane)
    c = RpcClient(port=args.rpc_port,
                  client_id=f"soak-{args.rpc_tenant}",
                  retry_ms=5.0, deadline_s=120.0)
    c.hello()
    c.start_heartbeat()
    s = c.open_session(args.rpc_tenant)
    info = c.register_shuffle(s, args.rpc_shuffle_id)  # 0 -> daemon mesh
    mesh = info["num_parts"]
    rng = np.random.default_rng(args.seed)
    x = rng.integers(0, 2**32,
                     size=(mesh * args.records_per_device,
                           args.rpc_record_words),
                     dtype=np.uint32)
    c.write(s, args.rpc_shuffle_id, x)
    rows, totals = c.read(s, args.rpc_shuffle_id)
    c.unregister_shuffle(s, args.rpc_shuffle_id)
    c.close_session(s)
    c.close()

    hard = plane.injected_total(("fail", "corrupt"))
    books = hard == (c.stats["retries"] + faults.recovery_total()
                     + faults.degradation_total())
    print("RPCSOAK " + json.dumps({
        "tenant": args.rpc_tenant,
        "digest": outputs_digest((rows, totals)),
        "rows": int(np.asarray(totals).sum()),
        "hard_injections": hard,
        "retries": c.stats["retries"],
        "sites_hit": plane.sites_hit(),
        "books_balanced": books,
    }), flush=True)
    return 0 if books else 1


def run_rpc_leg(args, common: dict, tmp: str) -> dict:
    """The out-of-process pass: two tenant worker PROCESSES, one daemon.

    The daemon (this process) serves the wire protocol; a clean and a
    noisy worker subprocess each run the seeded repartition through it.
    The noisy worker's plane corrupts/fails/delays its own ``rpc.send``
    / ``rpc.recv`` — transient, so its retry loop must converge to the
    control output. Verdict fields:

    - ``identical``: each worker's output digest == its solo in-process
      control's digest, bitwise
    - ``clean`` / ``noisy``: each worker's self-reported ledger — the
      clean one must show zero injections and zero retries (per-process
      blast radius), the noisy one balanced books with both wire sites
      hit
    - ``sessions_after`` / ``lease_events``: the daemon must be left
      empty, with both leases granted and cleanly closed in the journal
    """
    import subprocess

    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.obs.journal import read_entries

    rpd = max(args.records_per_device // 8, 64)
    noisy_spec = ("rpc.send:corrupt@attempt<2;rpc.recv:fail@attempt<2;"
                  "rpc.send:delay=2ms@0.2")
    tenants = (("clean", 21, args.seed + 50, ""),
               ("noisy", 22, args.seed + 60, noisy_spec))

    # --- solo in-process controls (same conf geometry, same seeds) -----
    conf_ctl = ShuffleConf(spill_dir=os.path.join(tmp, "rpc_ctl"),
                           **common)
    control_digest = {}
    with new_service(conf_ctl, args) as svc:
        for tenant, sid, seed, _spec in tenants:
            out, _ = run_service_tenant_leg(svc, tenant, None, seed,
                                            rpd, shuffle_id=sid)
            control_digest[tenant] = outputs_digest(out)

    # --- the daemon + two worker processes over the wire ---------------
    journal = os.path.join(tmp, "rpc_journal.jsonl")
    conf_svc = ShuffleConf(spill_dir=os.path.join(tmp, "rpc_duo"),
                           metrics_sink=journal, rpc_port=0, **common)
    workers: dict = {}
    errors: list = []
    with new_service(conf_svc, args) as svc:
        procs = {}
        for tenant, sid, seed, spec in tenants:
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--rpc-worker",
                   "--rpc-port", str(svc.rpc.port),
                   "--rpc-tenant", tenant,
                   "--rpc-shuffle-id", str(sid),
                   "--rpc-record-words", str(svc.conf.record_words),
                   "--rpc-fault-spec", spec,
                   "--seed", str(seed),
                   "--records-per-device", str(rpd)]
            procs[tenant] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        for tenant, p in procs.items():
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            line = next((ln for ln in out.splitlines()
                         if ln.startswith("RPCSOAK ")), None)
            if p.returncode != 0 or line is None:
                errors.append(f"{tenant}: rc={p.returncode} "
                              f"out={out[-2000:]}")
            else:
                workers[tenant] = json.loads(line[len("RPCSOAK "):])
        sessions_after = svc.stats()["sessions"]
        admission_after = svc.stats()["admission"]["active"]
    lease_events = [e["event"] for e in read_entries(journal)
                    if e.get("kind") == "lease"]

    clean = workers.get("clean", {})
    noisy = workers.get("noisy", {})
    identical = {t: workers.get(t, {}).get("digest") == control_digest[t]
                 for t in control_digest}
    ok = (not errors and all(identical.values())
          and clean.get("hard_injections") == 0
          and clean.get("retries") == 0
          and clean.get("books_balanced") is True
          and noisy.get("hard_injections", 0) >= 4
          and set(noisy.get("sites_hit", ())) >= {"rpc.send", "rpc.recv"}
          and noisy.get("books_balanced") is True
          and sessions_after == 0 and admission_after == 0
          and lease_events.count("grant") == 2
          and lease_events.count("close") == 2)
    return {
        "ok": ok,
        "errors": errors,
        "identical": identical,
        "clean": clean,
        "noisy": noisy,
        "sessions_after": sessions_after,
        "admission_after": admission_after,
        "lease_events": lease_events,
    }


def run_combine_leg(args, common: dict, tmp: str) -> dict:
    """Map-side combine vs combine-off control, chaos on the combined side.

    Same seeded duplicate-heavy data twice: a fault-free control with
    ``map_side_combine="off"``, then a chaos pass with the combine pass
    forced ON under transient faults at ``exchange.dispatch`` and (when
    the native codec is built) ``serde.encode`` — the rows are built
    through ``encode_bytes_rows`` precisely so the encode site sits on
    this leg's path. Verdict fields:

    - ``identical``: combined chaos output == uncombined control, bitwise
    - ``combined``: the chaos pass really shipped fewer bytes (its
      ``combine_out_bytes`` is non-zero and below ``combine_in_bytes``)
      while the control shipped uncombined (``combine_out_bytes == 0``)
    - ``wire_reduction_ratio`` / ``sites_hit``: evidence for the report
    """
    import numpy as np

    from sparkrdma_tpu_torch import ShuffleConf, faults
    from sparkrdma_tpu_torch.api import serde
    from sparkrdma_tpu_torch.api.dataset import Dataset

    spec = "exchange.dispatch:fail@attempt<2"
    if serde.native_codec_available():
        spec += ";serde.encode:fail@attempt<1"
    rpd = max(args.records_per_device // 2, 256)

    def leg(conf):
        m = new_manager(conf, args)
        try:
            mesh = m.runtime.num_partitions
            n = mesh * rpd
            rng = np.random.default_rng(args.seed + 30)
            keys = np.zeros((n, 2), dtype=np.uint32)
            keys[:, 1] = rng.integers(0, max(n // 16, 4), size=n,
                                      dtype=np.uint32)
            vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            payloads = [int(v).to_bytes(4, "little") for v in vals]
            rows = serde.encode_bytes_rows(keys, payloads, 24)
            ds = Dataset.from_host_rows(m, rows).reduce_by_key("sum")
            out = ds.to_host_rows().copy()
            ws = m._exchange.wire_stats()
            return out, ws, sorted(m.faults.sites_hit())
        finally:
            m.stop()

    conf_off = ShuffleConf(spill_dir=os.path.join(tmp, "cmb_ctl"),
                           map_side_combine="off", **common)
    control, ws_off, _ = leg(conf_off)

    faults.reset_accounting()
    conf_on = ShuffleConf(spill_dir=os.path.join(tmp, "cmb_chaos"),
                          map_side_combine="on", fault_spec=spec,
                          **common)
    chaos, ws_on, sites = leg(conf_on)

    identical = outputs_equal(control, chaos)
    in_b = int(ws_on.get("combine_in_bytes", 0))
    out_b = int(ws_on.get("combine_out_bytes", 0))
    # combine-off wire stats carry no combine_* byte keys at all — the
    # control must not have combined
    combined = (0 < out_b < in_b
                and int(ws_off.get("combine_out_bytes", 0)) == 0)
    ratio = round(in_b / out_b, 3) if out_b else None
    ok = identical and combined and "exchange.dispatch" in sites
    return {
        "ok": ok,
        "identical": identical,
        "combined": combined,
        "unique_rows": int(chaos.shape[0]),
        "combine_in_bytes": in_b,
        "combine_out_bytes": out_b,
        "wire_reduction_ratio": ratio,
        "sites_hit": sites,
    }


def run_planner_leg(args, common: dict, tmp: str) -> dict:
    """Query-planner rewrites under chaos vs the naive knobs-off control.

    The star-schema suite (workloads/tpcds.py) runs twice over the same
    seeded tables: a fault-free CONTROL with every ``plan_*`` knob OFF
    (the naive replay arm), then a CHAOS pass with every rewrite ON
    under transient ``exchange.dispatch`` faults — sunk filters,
    broadcast builds and adopted reuse outputs must all survive retries
    and still produce the control's exact grouped sums. Verdict fields:

    - ``identical``: chaos (rewrites + faults) == control, group for
      group, sum for sum — and both arms numpy-verified
    - ``rewrote``: the chaos arm really exercised the planner (its
      ``plan.reuse_hits`` and ``plan.broadcast_joins`` counters are
      non-zero; the control arm, knobs off, has none)
    - ``sites_hit``: the dispatch fault site must be on the path
    """
    from sparkrdma_tpu_torch import ShuffleConf, faults
    from sparkrdma_tpu_torch.workloads.tpcds import run_star_suite

    rpd = max(args.records_per_device // 16, 32)
    geom = dict(common, val_words=4,      # the 3-join chain's W=6 shape
                collect_shuffle_read_stats=True)

    def leg(conf):
        m = new_manager(conf, args)
        try:
            res = run_star_suite(m, fact_rows_per_device=rpd, scale=1,
                                 seed=args.seed)
            snap = m.metrics.snapshot()
            plan_counters = {k: int(v) for k, v in snap.items()
                             if k.startswith("plan.")}
            return res, plan_counters, sorted(m.faults.sites_hit())
        finally:
            m.stop()

    conf_ctl = ShuffleConf(spill_dir=os.path.join(tmp, "plan_ctl"),
                           plan_pushdown=False, plan_reuse=False,
                           plan_broadcast_join=False, plan_overlap=False,
                           **geom)
    control, ctl_counters, _ = leg(conf_ctl)

    faults.reset_accounting()
    conf_x = ShuffleConf(spill_dir=os.path.join(tmp, "plan_chaos"),
                         fault_spec="exchange.dispatch:fail@attempt<2",
                         **geom)
    chaos, counters, sites = leg(conf_x)

    identical = (
        control.verified and chaos.verified
        and (control.rev_groups, control.rev_total,
             control.all_groups, control.all_total)
        == (chaos.rev_groups, chaos.rev_total,
            chaos.all_groups, chaos.all_total))
    rewrote = (counters.get("plan.reuse_hits", 0) > 0
               and counters.get("plan.broadcast_joins", 0) > 0
               and not ctl_counters)
    ok = identical and rewrote and "exchange.dispatch" in sites
    return {
        "ok": ok,
        "identical": identical,
        "rewrote": rewrote,
        "plan_counters": counters,
        "sites_hit": sites,
    }


def run_alert_leg(args, common: dict, tmp: str) -> dict:
    """Alerting E2E: chaos must fire and journal spill + straggler
    alerts — surfaced by the probe's ``/alerts`` AND by
    ``shuffle_report --doctor``'s alert evidence — while an identical
    fault-free control arm fires none.

    Both arms run the same two-phase workload with the live evaluator
    wired (telemetry sampling fast; evaluation driven deterministically
    through ``evaluate_once`` so the verdict never races a wall-clock
    thread):

    - a repeated-read shuffle where the chaos arm's injected dispatch
      delay makes the first read dwarf the rest (one rollup window with
      ``lat_max >> mean`` -> the ``straggler_spread`` rule), while the
      control arm's reads are uniform;
    - a tiered-store TeraSort whose host budget is TINY in the chaos
      arm (chunks cycle to disk -> ``store.spill_bytes`` moves -> the
      ``spill_storm`` rule) and ample in the control arm (no spill).

    First-read costs (a kernel's load, the pool's first allocations)
    must not masquerade as a straggler: each arm warms its OWN manager
    up with a separate warm-up shuffle (few reads — below the straggler
    rule's minimum) while its fault plane is still disabled, and the
    chaos schedule is installed via ``faults.set_active_plane`` only
    around the measured reads.
    """
    import subprocess
    import time as _time

    import numpy as np

    from sparkrdma_tpu_torch import ShuffleConf, faults
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    rpd = max(args.records_per_device // 4, 256)
    chunk = max(rpd // 2, 128)
    rng = np.random.default_rng(args.seed + 40)

    def arm(name, chaos):
        journal = os.path.join(tmp, f"alert_{name}.jsonl")
        kw = dict(common)
        seg_bytes = chunk * 9 * 4            # record_words columns, u32
        conf = ShuffleConf(
            spill_dir=os.path.join(tmp, f"alert_{name}_spill"),
            spill_tier_dir=os.path.join(tmp, f"alert_{name}_tier"),
            # chaos: ~2 of 4 chunks host-resident, the rest cycle disk
            spill_tier_host_bytes=(2 * seg_bytes if chaos else 1 << 30),
            spill_tier_prefetch=1,
            metrics_sink=journal,
            probe_port=0,
            telemetry_window_s=0.05,
            rollup_window_s=2.0,
            alert_eval_s=3600.0,        # thread parked: evaluate_once drives
            alert_fire_breaches=1,
            alert_resolve_windows=1000,  # alerts stay active for /alerts
            **kw)
        m = new_manager(conf, args)
        fired = []
        probe_alerts = []
        try:
            w = m.conf.record_words
            mesh = m.runtime.num_partitions
            part = hash_partitioner(mesh, m.conf.key_words)
            x = rng.integers(0, 2**32, size=(mesh * rpd, w),
                             dtype=np.uint32)

            # warm-up shuffle: absorbs the first-read costs. 3 reads is
            # below the straggler rule's 4-read minimum, so this series
            # can never breach — and the fault plane is not installed
            # yet, so no fault budget is consumed here.
            hw = m.register_shuffle(40, mesh, part)
            m.get_writer(hw).write(m.runtime.shard_records(x)).stop(True)
            for _ in range(3):
                m.get_reader(hw).read()
            m.unregister_shuffle(40)

            h = m.register_shuffle(43, mesh, part)
            m.get_writer(h).write(m.runtime.shard_records(x)).stop(True)
            reader = m.get_reader(h)
            # a DELAY fault, not a fail: retry backoff is deliberately
            # excluded from span latency (exec_s times only the winning
            # attempt), so only time spent inside the dispatch itself
            # can show up as a straggler — exactly what a slow peer
            # looks like in production
            plane = faults.FaultPlane(
                "exchange.dispatch:delay=300ms@attempt<1" if chaos
                else "")
            # start the recorded reads at a rollup window's edge, so all
            # 13 fall in one window: a window that closed between them
            # would leave the stalled read out of the shuffle's last
            # window, the only one the straggler rule reads
            win = m.rollup.window_s
            _time.sleep(win - m.rollup._clock() % win + 0.01)
            prev = faults.set_active_plane(plane if chaos else None)
            try:
                # recorded reads: only those feed the rollup windows the
                # straggler rule consumes. Chaos: the first read eats the
                # injected 300ms stall, the rest run clean, so ONE
                # window shows lat_max >> median.
                for _ in range(13):
                    reader.read()
            finally:
                faults.set_active_plane(prev)
            run_tiered_terasort(m, np.ascontiguousarray(
                rng.integers(0, 2**32, size=(w, 4 * chunk),
                             dtype=np.uint32)),
                chunk_records=chunk, collect=False, shuffle_id_base=960)

            # close the read phase's rollup window, give the 50ms
            # sampler a couple of ticks, then evaluate deterministically
            _time.sleep(conf.rollup_window_s + 0.3)
            reader.read()                     # emits the old window
            _time.sleep(0.15)
            for _ in range(2):
                fired.extend(m.alerts.evaluate_once())
            m.unregister_shuffle(43)
            if m.probe is not None:
                try:
                    probe_alerts = probe_fetch(
                        m.probe.port, "/alerts").get("alerts", [])
                except (OSError, ValueError):
                    pass
        finally:
            m.stop()
        return journal, fired, probe_alerts

    journal_x, fired_x, probe_x = arm("chaos", chaos=True)
    _, fired_c, probe_c = arm("control", chaos=False)

    # the journal is closed now: --doctor must surface the alert lines
    # as first-class evidence (the subprocess IS the operator workflow)
    report = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "shuffle_report.py")
    doc = subprocess.run([sys.executable, report, journal_x, "--doctor"],
                         capture_output=True, text=True)
    doctor_alerts = [ln for ln in doc.stdout.splitlines()
                     if "ALERT " in ln]

    chaos_rules = sorted({al.get("rule") for al in fired_x
                          if al.get("event") == "fired"})
    probe_rules = sorted({al.get("rule") for al in probe_x})
    control_rules = sorted({al.get("rule") for al in fired_c})
    ok = ("spill_storm" in chaos_rules
          and "straggler_spread" in chaos_rules
          and "spill_storm" in probe_rules
          and "straggler_spread" in probe_rules
          and bool(doctor_alerts)
          and not fired_c and not probe_c)
    return {
        "ok": ok,
        "chaos_fired_rules": chaos_rules,
        "chaos_probe_rules": probe_rules,
        "doctor_alert_lines": len(doctor_alerts),
        "control_fired": len(fired_c),
        "control_rules": control_rules,
        "control_probe_alerts": len(probe_c),
    }


def outputs_equal(a, b) -> bool:
    import numpy as np

    if type(a) is not type(b):
        return False
    if isinstance(a, tuple):
        return len(a) == len(b) and all(
            outputs_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and a.dtype == b.dtype \
            and bool(np.array_equal(a, b))
    return a == b


def read_spans(path: str) -> list:
    spans = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "retry_count" in obj:     # span lines (not rollup/heartbeat)
                spans.append(obj)
    return spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="shuffle chaos soak of the PyTorch port: workloads "
                    "under injected faults, bit-identical vs a fault-free "
                    "control")
    ap.add_argument("--seed", type=int, default=0,
                    help="schedule + data seed (failing seeds replay)")
    ap.add_argument("--records-per-device", type=int, default=2048)
    ap.add_argument("--partitions", type=int, default=8,
                    help="shuffle partitions stacked on the device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without one) or cpu")
    ap.add_argument("--transport", default="xla",
                    help="the exchange's transport (pallas_ring: the "
                         "hand-written ring kernel)")
    # --rpc-worker self-invocation flags (the out-of-process RPC pass
    # re-runs this script as a pure wire-protocol client; see
    # rpc_worker_main). Not for interactive use.
    ap.add_argument("--rpc-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--rpc-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rpc-tenant", default="", help=argparse.SUPPRESS)
    ap.add_argument("--rpc-shuffle-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rpc-record-words", type=int, default=9,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rpc-fault-spec", default="",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.rpc_worker:
        # pure RPC client: no runtime, no device — the daemon process
        # owns the data plane
        return rpc_worker_main(args)

    import torch

    from sparkrdma_tpu_torch import ShuffleConf, faults
    from sparkrdma_tpu_torch.api import serde

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device (pass "
                           "--device cpu to soak on the host)")

    pyrng = random.Random(args.seed)
    spec = build_spec(pyrng, include_serde=serde.native_codec_available())

    common = dict(
        slot_records=256,
        max_rounds=64,
        max_rounds_in_flight=1,      # force the streaming regime
        val_words=7,                 # fits the 24-byte serde payloads
        spill_to_host=True,          # every stop() checkpoints
        max_retry_attempts=8,
        retry_backoff_ms=1.0,
        retry_deadline_s=60.0,
        transport=args.transport,
    )

    with tempfile.TemporaryDirectory(prefix="torch_chaos_soak_") as tmp:
        # --- control pass: no faults -----------------------------------
        print("control pass (no faults)...", file=sys.stderr, flush=True)
        conf_c = ShuffleConf(spill_dir=os.path.join(tmp, "ctl"), **common)
        mc = new_manager(conf_c, args)
        try:
            control = run_legs(mc, args.seed, args.records_per_device)
        finally:
            mc.stop()

        faults.reset_accounting()

        # --- chaos pass: same data, fault schedule active --------------
        print(f"chaos pass: {spec}", file=sys.stderr, flush=True)
        journal = os.path.join(tmp, "journal.jsonl")
        conf_x = ShuffleConf(spill_dir=os.path.join(tmp, "chaos"),
                             fault_spec=spec, metrics_sink=journal,
                             **common)
        mx = new_manager(conf_x, args)
        try:
            chaos = run_legs(mx, args.seed, args.records_per_device)
            plane = mx.faults
        finally:
            mx.stop()

        spans = read_spans(journal)
        retries = sum(int(s.get("retry_count") or 0) for s in spans)
        backoffs = [b for s in spans for b in (s.get("backoff_ms") or [])]
        spans_missing_backoff = [
            s["span_id"] for s in spans
            if (s.get("retry_count") or 0) > 0 and not s.get("backoff_ms")]

        injected = plane.injected_counts()
        hard = plane.injected_total(("fail", "corrupt"))
        recoveries = faults.recovery_counts()
        degradations = faults.active_degradations()
        books = hard == retries + faults.recovery_total() \
            + faults.degradation_total()

        # --- two-tenant blast-radius pass (fresh accounting) -----------
        faults.reset_accounting()
        print("two-tenant pass: noisy + clean through one service...",
              file=sys.stderr, flush=True)
        tenant_leg = run_two_tenant_leg(args, common, tmp)

        # --- map-side combine pass (fresh accounting) ------------------
        faults.reset_accounting()
        print("combine pass: forced map-side combine under faults...",
              file=sys.stderr, flush=True)
        combine_leg = run_combine_leg(args, common, tmp)

        # --- out-of-process RPC pass (fresh accounting) ----------------
        faults.reset_accounting()
        print("rpc pass: two worker processes over the wire protocol...",
              file=sys.stderr, flush=True)
        rpc_leg = run_rpc_leg(args, common, tmp)

        # --- alerting pass (fresh accounting) --------------------------
        faults.reset_accounting()
        print("alert pass: chaos fires spill+straggler, control stays "
              "quiet...", file=sys.stderr, flush=True)
        alert_leg = run_alert_leg(args, common, tmp)

        # --- planner pass (fresh accounting) ---------------------------
        faults.reset_accounting()
        print("planner pass: DAG rewrites under faults vs naive "
              "knobs-off control...", file=sys.stderr, flush=True)
        planner_leg = run_planner_leg(args, common, tmp)

    identical = {leg: outputs_equal(control[leg], chaos[leg])
                 for leg in control}
    sites = plane.sites_hit()
    ok = (all(identical.values()) and len(sites) >= 6 and books
          and not spans_missing_backoff and tenant_leg["ok"]
          and combine_leg["ok"] and rpc_leg["ok"] and alert_leg["ok"]
          and planner_leg["ok"])

    print(json.dumps({
        "ok": ok,
        "seed": args.seed,
        "fault_spec": spec,
        "sites_hit": sorted(sites),
        "injected": injected,
        "hard_injections": hard,
        "journal_retries": retries,
        "recoveries": recoveries,
        "degradations": degradations,
        "books_balanced": books,
        "backoff_ms_total": round(sum(backoffs), 3),
        "spans_missing_backoff": spans_missing_backoff,
        "bit_identical": identical,
        "tenant_leg": tenant_leg,
        "combine_leg": combine_leg,
        "rpc_leg": rpc_leg,
        "alert_leg": alert_leg,
        "planner_leg": planner_leg,
        "device": str(args.device),
        "transport": args.transport,
    }, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
