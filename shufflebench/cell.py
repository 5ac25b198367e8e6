"""One cell: a configuration (the deployment) under a traffic mix.

A job is one shuffle stage seen from the client's side, the way a Spark
application submits it: for a sorted read, sampling and splitters first
(``make_sampler`` / ``compute_splitters``, which the range partitioner
needs before the shuffle can be registered); then ``register_shuffle``,
``get_writer(h).write(records).stop()`` (the plan),
``get_reader(h, ...).read()``, ``torch.cuda.synchronize()`` and
``unregister_shuffle``. Its clock runs from the first of these steps to
the return of the last. Each step runs inside a ``record_function``
range named as in ``trace.RANGES``.

Records are made on the device from the run's seed and the job's index,
outside the job's clock: the payload words once at set-up, the key
words anew for every job, so nothing keyed on a job's input can serve a
later one. The program receives only the generated tensors.
"""

import time

import torch
from torch.profiler import record_function

from shufflebench import registry

#: streams of the seed: each draw of the run has its own
PAYLOAD, WINDOW_JOBS, WARMUP_JOBS, TRACED_JOBS, CHECKS = range(5)
#: a job's sampler draws from stream ``SAMPLER + <the job's stream>``
SAMPLER = 16


def job_seed(seed: int, stream: int, idx: int) -> int:
    """A 40-bit seed for draw ``idx`` of ``stream`` (splitmix64's mix)."""
    z = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + idx * 0x94D049BB133111EB + 1) & (2 ** 64 - 1)
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mul) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) >> 24


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_words(specs, n, seed, device) -> torch.Tensor:
    """The words of ``specs`` (``[{"words", "dist", ...params}]``), in
    order, from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    parts = []
    for spec in specs:
        params = {k: v for k, v in spec.items() if k not in ("words", "dist")}
        parts.append(registry.generator(spec["dist"])(
            n, spec["words"], gen, device, **params))
    return torch.cat(parts)


class Cell:
    """The deployment, its traffic and the manager that serves it."""

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 overrides: dict = None):
        from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
        from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
        from sparkrdma_tpu_torch.exchange import partitioners

        overrides = overrides or {}
        self.mix = mix
        self.seed, self.device = seed, torch.device(device)
        self.parts = config["partitions"]
        self.key_words = config["key_words"]
        self.words = config["key_words"] + config["val_words"]
        self.n = overrides.get("records_per_job", config["records_per_job"])
        self.record_bytes = 4 * self.words
        if self.record_bytes != config["record_bytes"]:
            raise ValueError(f"{config['name']}: {self.words} words are not "
                             f"{config['record_bytes']} bytes")
        conf = dict(config["conf"], **overrides.get("conf", {}))
        self.conf = ShuffleConf(key_words=self.key_words,
                                val_words=config["val_words"], **conf)
        self.manager = ShuffleManager(MeshRuntime(
            self.conf, num_partitions=self.parts, device=self.device))
        # "range": splitters sampled from each job's records; any other
        # kind is the program's ``<kind>_partitioner`` over the whole key,
        # one for every job
        kind = mix["partitioner"]
        self.fixed_part = None
        if kind != "range":
            self.fixed_part = getattr(partitioners, f"{kind}_partitioner")(
                self.parts, self.key_words)
        self.payload = make_words(config["payload"], self.n,
                                  job_seed(seed, PAYLOAD, 0), self.device)
        if self.payload.shape[0] != config["val_words"]:
            raise ValueError("payload specs do not fill val_words")
        self._next_id = 0

    # -- inputs ------------------------------------------------------------
    def records(self, stream: int, idx: int) -> torch.Tensor:
        """Job ``idx`` of ``stream``'s records ``int32[W, n]``."""
        with record_function("gen"):
            keys = make_words(self.mix["keys"], self.n,
                              job_seed(self.seed, stream, idx), self.device)
            if keys.shape[0] != self.key_words:
                raise ValueError("key specs do not fill key_words")
            return torch.cat([keys, self.payload])

    def sampler_seed(self, stream: int, idx: int) -> int:
        return job_seed(self.seed, SAMPLER + stream, idx)

    # -- one job -----------------------------------------------------------
    def _range_partitioner(self, records, sampler_seed: int):
        from sparkrdma_tpu_torch.exchange.partitioners import \
            range_partitioner
        from sparkrdma_tpu_torch.meta.sampling import (compute_splitters,
                                                       make_sampler)

        m = self.manager
        sampler = make_sampler(self.parts, self.key_words,
                               self.mix["samples_per_partition"],
                               sampler_seed, runtime=m.runtime,
                               collectives=m.collectives)
        splitters = compute_splitters(sampler(records), self.parts)
        return range_partitioner(splitters, self.key_words)

    def job(self, records: torch.Tensor, sampler_seed: int):
        """Run one job; returns ``(record, out, totals)``: the job's
        times and counts, and the read's output (valid until the next
        job)."""
        m = self.manager
        sid = self._next_id
        self._next_id += 1
        spans = {}
        t0 = time.perf_counter()
        t = t0
        part = self.fixed_part
        if part is None:
            with record_function("sample"):
                part = self._range_partitioner(records, sampler_seed)
            spans["sample"] = time.perf_counter() - t
            t = time.perf_counter()
        with record_function("register"):
            handle = m.register_shuffle(sid, self.parts, part)
        spans["register"] = time.perf_counter() - t
        t = time.perf_counter()
        with record_function("write_plan"):
            plan = m.get_writer(handle).write(records).stop()
        spans["write_plan"] = time.perf_counter() - t
        t = time.perf_counter()
        with record_function("read"):
            out, totals = m.get_reader(handle, **self.mix["reader"]).read()
            sync(self.device)
        spans["read"] = time.perf_counter() - t
        t = time.perf_counter()
        with record_function("unregister"):
            m.unregister_shuffle(sid)
        t1 = time.perf_counter()
        spans["unregister"] = t1 - t
        # the map-side combine's wire accounting (host numbers after the
        # read's sync); the exchange keeps it for its last read only
        wire = m._exchange.wire_stats()
        record = {
            "start": t0, "end": t1, "seconds": t1 - t0, "spans": spans,
            "records": int(records.shape[1]),
            "bytes": int(records.shape[1]) * self.record_bytes,
            "record_bytes": self.record_bytes, "partitions": self.parts,
            "rounds_in_flight": self.conf.max_rounds_in_flight,
            "plan": {"num_rounds": plan.num_rounds,
                     "capacity": plan.capacity,
                     "split_factor": plan.split_factor,
                     "out_capacity": plan.out_capacity,
                     "plan_parts": int(plan.counts.shape[1]),
                     "total_records": plan.total_records},
            "wire": dict(wire)}
        return record, out, totals

    def keep(self, out: torch.Tensor, totals: torch.Tensor):
        """Every partition's valid records of a read, one after another,
        copied to the host word by word (no copy on the device), and each
        partition's count."""
        tot = [int(t) for t in totals.tolist()]
        oc = out.shape[1] // self.parts
        rows = torch.empty((out.shape[0], sum(tot)), dtype=out.dtype)
        at = 0
        for p, t in enumerate(tot):
            for w in range(out.shape[0]):
                rows[w, at:at + t].copy_(out[w, p * oc:p * oc + t])
            at += t
        return rows, tot

    def stop(self) -> None:
        """Stop the program's manager (the payload, the benchmark's own,
        stays for the check)."""
        self.manager.stop()
        self.manager = None
