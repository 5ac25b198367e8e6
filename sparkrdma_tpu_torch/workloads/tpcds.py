"""TPC-DS-shaped multi-join queries — ``BASELINE.md`` config 3, run by the
query planner.

Counterpart of ``sparkrdma_tpu.workloads.tpcds``. The queries are written
naively against the planner (``plan/``): join, filter, select, reduce in
SQL order, and the optimizer's rewrites do the rest:

  pushdown      the post-join ``key != 0`` filter fuses into the final
                exchange's ``row_filter`` (and sinks below
                layout-preserving exchanges), so dead rows take no slot;
  broadcast     dimension sides under ``plan_broadcast_records``
                replicate to every partition and skip the co-partition
                exchanges;
  reuse         exchanges with identical fingerprints adopt an earlier
                output;
  overlap       deferred host tables encode in the background while an
                earlier exchange runs.

With every ``plan_*`` knob off the same plans replay the naive dataflow
bit-identically.

Dimension joins are primary-key lookups, so a join's output has the
FACT's shape; padding rows carry key 0 (real keys are 1-based) and
aggregate into a discarded null group. The tables are made from a seed
with numpy exactly as the reference makes them, and each query is
checked against numpy (grouped sums, vectorized).

q64 record layout (W=4): [key_hi=0, key_lo, payload0, payload1].
  fact:            key=item_key,  payload=(store_key, value)
  after join 1:    key=store_key, payload=(category, value)
  after join 2:    key=category,  payload=(region attr, value)

The star-schema suite (:func:`run_star_suite`) needs ``val_words=4``
(W=6) and chains three dimension joins; see its docstring.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.dataset import Dataset, _parts
from sparkrdma_tpu_torch.api.serde import RowSchema
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.plan import LogicalPlan, PlanExecutor
from sparkrdma_tpu_torch.utils.stats import barrier

_PAD_KEY = 0xFFFFFFFF


@dataclasses.dataclass
class QueryResult:
    fact_rows: int
    groups: int                  # distinct non-null categories in output
    total_value: int             # sum over qualifying fact rows
    shuffle_s: float
    verified: Optional[bool] = None


def _drop_null_key(records):
    """The naive post-join WHERE: rows the store join left unmatched
    carry the null key 0. The pushdown pass fuses it into the group_agg
    exchange's ``row_filter``."""
    return records[1] != 0


_drop_null_key.cache_key = ("tpcds_drop_null",)


def _grouped(keys: np.ndarray, values: np.ndarray) -> Dict[int, int]:
    """``{key: sum of values}`` over the rows whose key is not 0 (the
    null group). The keys here are dimension attributes, small integers,
    so they are binned directly (float64 sums of these integers are
    exact)."""
    keys = keys.astype(np.int64)
    live = keys != 0
    keys, values = keys[live], values[live]
    sums = np.bincount(keys, weights=values)
    return {int(k): int(sums[k]) for k in np.flatnonzero(np.bincount(keys))}


def _q64_tables(mesh: int, fact_rows_per_device: int, n_items: int,
                n_stores: int, n_categories: int, n_regions: int,
                seed: int):
    """``(fact, item, store)`` host rows, as the reference makes them."""
    rng = np.random.default_rng(seed)
    nf = mesh * fact_rows_per_device
    fact = np.zeros((nf, 4), dtype=np.uint32)
    fact[:, 1] = rng.integers(1, n_items + 1, size=nf)        # item_key
    fact[:, 2] = rng.integers(1, n_stores + 1, size=nf)       # store_key
    fact[:, 3] = rng.integers(1, 100, size=nf)                # value
    item = np.zeros((max(mesh, n_items), 4), dtype=np.uint32)
    item[:n_items, 1] = np.arange(1, n_items + 1)             # PK
    item[:n_items, 2] = rng.integers(1, n_categories + 1, size=n_items)
    store = np.zeros((max(mesh, n_stores), 4), dtype=np.uint32)
    store[:n_stores, 1] = np.arange(1, n_stores + 1)          # PK
    store[:n_stores, 2] = rng.integers(0, n_regions, size=n_stores)
    return fact, item, store


def _q64_plan(manager: ShuffleManager, fact: np.ndarray, item: np.ndarray,
              store: np.ndarray, region_cutoff: int) -> LogicalPlan:
    """Load the three tables and write q64 naively: join item, join the
    region-qualified stores, filter the null key, grouped sum."""

    def region_pred(r, _c=region_cutoff):
        return as_unsigned(r[2]) < _c

    region_pred.cache_key = ("tpcds_region", region_cutoff)
    fact_p = LogicalPlan.dataset(Dataset.from_host_rows(manager, fact),
                                 name="tpcds_fact")
    item_p = LogicalPlan.dataset(Dataset.from_host_rows(manager, item),
                                 name="tpcds_item")
    store_p = LogicalPlan.dataset(Dataset.from_host_rows(manager, store),
                                  name="tpcds_store")
    # WHERE region < cutoff lives on the DIM side: non-qualifying stores
    # leave the dim table, their fact rows come out of the store join
    # unmatched (key 0), and the null-key filter drops them
    return (fact_p
            .join(item_p, key_from=0, attr_to=0, stage="item_join")
            .join(store_p.filter(region_pred), key_from=0, attr_to=0,
                  stage="store_join")
            .filter(_drop_null_key)
            .reduce_by_key("sum", stage="group_agg"))


def _q64_expect(fact: np.ndarray, item: np.ndarray, store: np.ndarray,
                n_items: int, n_stores: int,
                region_cutoff: int) -> Dict[int, int]:
    """numpy's grouped sums: value by item category over the fact rows
    whose store's region is below the cutoff (WHERE before GROUP BY: a
    category with no qualifying row has no group)."""
    cat_of = np.zeros(n_items + 1, np.int64)
    cat_of[item[:n_items, 1]] = item[:n_items, 2]
    reg_of = np.zeros(n_stores + 1, np.int64)
    reg_of[store[:n_stores, 1]] = store[:n_stores, 2]
    qual = reg_of[fact[:, 2]] < region_cutoff
    return _grouped(cat_of[fact[qual, 1]], fact[qual, 3])


def run_q64_shape(
    manager: ShuffleManager,
    fact_rows_per_device: int = 256,
    n_items: int = 256,
    n_stores: int = 64,
    n_categories: int = 16,
    region_cutoff: int = 3,
    n_regions: int = 8,
    seed: int = 0,
    shuffle_ids: Tuple[int, int, int, int, int] = (40, 41, 42, 43, 44),
    verify: bool = True,
    executor=None,
) -> QueryResult:
    """Run the q64 shape through the query planner and check its grouped
    sums against numpy. ``shuffle_ids`` is accepted for the reference's
    signature (the planner draws Dataset-layer ids). Pass ``executor``
    to share a :class:`PlanExecutor`'s reuse memo across queries."""
    del shuffle_ids
    fact, item, store = _q64_tables(
        manager.runtime.num_partitions, fact_rows_per_device, n_items,
        n_stores, n_categories, n_regions, seed)
    t0 = time.perf_counter()
    q = _q64_plan(manager, fact, item, store, region_cutoff)
    ex = executor or PlanExecutor(manager)
    out = ex.run(q, job_name="tpcds_q64")
    barrier(out.records)
    shuffle_s = time.perf_counter() - t0

    # after join 2: key = category, payload1 = the summed value
    rows = out.to_host_rows()
    groups = _grouped(rows[:, 1], rows[:, 3])
    verified = None
    if verify:
        verified = groups == _q64_expect(fact, item, store, n_items,
                                         n_stores, region_cutoff)
    return QueryResult(fact_rows=fact.shape[0], groups=len(groups),
                       total_value=sum(groups.values()),
                       shuffle_s=shuffle_s, verified=verified)


@dataclasses.dataclass
class Q95Result:
    sales_rows: int
    qualifying: int
    net_sum: float
    shuffle_s: float
    verified: Optional[bool] = None


def _q95_tables(mesh: int, sales_rows_per_device: int,
                return_rows_per_device: int, n_orders: int,
                n_warehouses: int, return_order_offset: int, seed: int):
    """``(sales, returns)`` host rows, as the reference makes them."""
    rng = np.random.default_rng(seed)
    ns = mesh * sales_rows_per_device
    nr = mesh * return_rows_per_device
    sales = np.zeros((ns, 4), dtype=np.uint32)
    sales[:, 1] = rng.integers(1, n_orders + 1, size=ns)      # order key
    sales[:, 2] = rng.integers(0, n_warehouses, size=ns)      # warehouse
    sales[:, 3] = rng.integers(1, 1000, size=ns)              # net paid
    returns = np.zeros((nr, 4), dtype=np.uint32)
    # return_order_offset >= n_orders moves every return out of the
    # sales' order space (the provably-zero-returns path)
    returns[:, 1] = (rng.integers(1, n_orders + 1, size=nr)
                     + return_order_offset)
    return sales, returns


def _q95_probe(sales: Dataset, returns: Dataset) -> Tuple[int, float]:
    """The semi/anti probe over co-partitioned tables, per partition:
    sales sorted by (order, warehouse), so an order ships from another
    warehouse too iff its run's first and last warehouses differ; a
    searchsorted probe into the sorted returns finds returned orders.
    The count and the float32 net of the qualifying rows, summed over
    the partitions (the reference's ``psum``)."""
    mesh = sales.manager.runtime.num_partitions
    count = 0
    nets = []
    for sc, ns_c, rc, nr_c in zip(_parts(sales.records, mesh),
                                  sales.totals.tolist(),
                                  _parts(returns.records, mesh),
                                  returns.totals.tolist()):
        dev = sc.device
        sv = torch.arange(sc.shape[1], device=dev) < ns_c
        rv = torch.arange(rc.shape[1], device=dev) < nr_c
        key = torch.where(sv, as_unsigned(sc[1]), _PAD_KEY)
        # (order, warehouse) lexicographic, stable: by warehouse, then
        # stably by order
        o = torch.sort(as_unsigned(sc[2]), stable=True).indices
        o = o[torch.sort(key[o], stable=True).indices]
        sk, swh, snet, svv = key[o], sc[2][o], sc[3][o], sv[o]
        lo = torch.searchsorted(sk, sk, side="left")
        hi = torch.searchsorted(sk, sk, side="right")
        exists_other = (swh[lo] != swh[(hi - 1).clamp_(min=0)]) & svv
        rsorted = torch.sort(torch.where(rv, as_unsigned(rc[1]),
                                         _PAD_KEY)).values
        ridx = torch.searchsorted(rsorted, sk).clamp_(max=rc.shape[1] - 1)
        returned = (rsorted[ridx] == sk) & svv
        qual = exists_other & ~returned
        count += int(qual.sum())
        nets.append(torch.where(qual, as_unsigned(snet), 0).to(
            torch.float32).sum())
    return count, float(torch.stack(nets).sum())


def _q95_expect(sales: np.ndarray, returns: np.ndarray,
                n_warehouses: int) -> Tuple[int, float]:
    """numpy's count and float64 net of the sales whose order ships from
    two or more warehouses and was never returned."""
    order = sales[:, 1].astype(np.int64)
    n = int(order.max(initial=0)) + 1
    pairs = np.bincount(order * n_warehouses + sales[:, 2],
                        minlength=n * n_warehouses)
    n_wh = (pairs.reshape(n, n_warehouses) > 0).sum(axis=1)
    rkeys = returns[:, 1].astype(np.int64)
    returned = np.zeros(max(n, int(rkeys.max(initial=0)) + 1), bool)
    returned[rkeys] = True
    qual = (n_wh[order] >= 2) & ~returned[order]
    return int(qual.sum()), float(sales[qual, 3].astype(np.float64).sum())


def run_q95_shape(
    manager: ShuffleManager,
    sales_rows_per_device: int = 256,
    return_rows_per_device: int = 64,
    n_orders: int = 512,
    n_warehouses: int = 8,
    return_order_offset: int = 0,
    seed: int = 0,
    shuffle_ids: Tuple[int, int] = (45, 46),
    verify: bool = True,
) -> Q95Result:
    """TPC-DS q95 shape: a self-SEMI-join (the order also ships from
    another warehouse) and an ANTI-join (never returned), both needing
    co-partitioning by order key, then a global aggregate. Both tables
    are hash-repartitioned by the planner (two exchanges), then
    :func:`_q95_probe` runs on the co-partitioned tables. Checked
    against numpy: the count exactly, the float32 net at rtol 1e-6."""
    del shuffle_ids
    sales, returns = _q95_tables(
        manager.runtime.num_partitions, sales_rows_per_device,
        return_rows_per_device, n_orders, n_warehouses,
        return_order_offset, seed)
    ex = PlanExecutor(manager)
    t0 = time.perf_counter()
    # the query's two job-trace stages (no-ops outside a job): both
    # co-partition exchanges, planner-run inline under the first, then
    # the probe join
    with _trace.stage("co_partition"):
        outs = [ex.run_inline(LogicalPlan.dataset(
            Dataset.from_host_rows(manager, table), name=name)
            .repartition())
            for name, table in (("q95_sales", sales),
                                ("q95_returns", returns))]
    barrier(outs[1].records)
    shuffle_s = time.perf_counter() - t0     # the exchanges only
    with _trace.stage("probe_join"):
        count, net_sum = _q95_probe(*outs)
    verified = None
    if verify:
        ref_cnt, ref_net = _q95_expect(sales, returns, n_warehouses)
        verified = (count == ref_cnt
                    and abs(net_sum - ref_net) <= 1e-6 * max(1.0, ref_net))
    return Q95Result(sales_rows=sales.shape[0], qualifying=count,
                     net_sum=net_sum, shuffle_s=shuffle_s,
                     verified=verified)


@dataclasses.dataclass
class StarResult:
    """One star-schema suite run: two queries over a shared fact."""

    fact_rows: int
    rev_groups: int              # q_star_rev: qualifying groups
    rev_total: int               # q_star_rev: summed value
    all_groups: int              # q_star_all: all groups
    all_total: int               # q_star_all: summed value
    suite_s: float
    verified: Optional[bool] = None


def _star_tables(mesh: int, fact_rows_per_device: int, scale: int,
                 seed: int):
    """Fact + three dimension tables for the star shape (W=6), as the
    reference makes them.

    Fact rows ``[0, d1k, d2k, d3k, value, 0]``; each dim table ``[0, pk,
    attr, 0, 0, 0]`` with 1-based unique PKs and 1-based attributes. Dim
    row counts are padded to a multiple of the partition count with
    key-0 rows, which never match a lookup."""
    rng = np.random.default_rng(seed)
    nf = mesh * fact_rows_per_device * scale
    n1, n2, n3 = 64 * scale, 32 * scale, 16 * scale
    n_a1 = 8 * scale

    def dim(n_rows: int, n_attr: int):
        n_pad = -(-n_rows // mesh) * mesh
        t = np.zeros((n_pad, 6), dtype=np.uint32)
        t[:n_rows, 1] = np.arange(1, n_rows + 1)          # unique PK
        t[:n_rows, 2] = rng.integers(1, n_attr + 1, size=n_rows)
        return t

    fact = np.zeros((nf, 6), dtype=np.uint32)
    fact[:, 1] = rng.integers(1, n1 + 1, size=nf)         # dim1 key
    fact[:, 2] = rng.integers(1, n2 + 1, size=nf)         # dim2 key
    fact[:, 3] = rng.integers(1, n3 + 1, size=nf)         # dim3 key
    fact[:, 4] = rng.integers(1, 100, size=nf)            # value
    return fact, dim(n1, n_a1), dim(n2, 8), dim(n3, 16)


def _star_pred(r):
    """Naive post-join WHERE: qualifying a2 band, non-null group key.
    Written AFTER the pre-aggregate repartition so the pushdown pass has
    something to sink. Its ``cache_key`` is the reference's, so the
    plans fingerprint alike."""
    return (as_unsigned(r[2]) < 5) & (r[1] != 0)


_star_pred.cache_key = ("star_rev_band", 5)

#: the join-3 output layout of the star chain
_STAR_OUT_SCHEMA = RowSchema([("a2", "uint32"), ("a3", "uint32"),
                              ("value", "uint32"), ("a1", "uint32")])


def _star_plans(manager: ShuffleManager, fact: np.ndarray, dims,
                scale: int, seed: int) -> Tuple[LogicalPlan, LogicalPlan]:
    """Load the fact and write both star queries naively over one shared
    fact repartition handle (the deferred dims load when reached)."""
    fact_r = LogicalPlan.dataset(
        Dataset.from_host_rows(manager, fact),
        name=f"star_fact_s{scale}_r{seed}").repartition(stage="fact_part")
    d1, d2, d3 = (LogicalPlan.from_host_rows(
        manager, t, name=f"star_dim{i}_s{scale}_r{seed}")
        for i, t in enumerate(dims, start=1))

    def joined(left: LogicalPlan) -> LogicalPlan:
        return (left
                .join(d1, key_from=0, attr_to=3, stage="dim1_join")
                .join(d2, key_from=1, attr_to=0, stage="dim2_join")
                .join(d3, key_from=3, attr_to=1, schema=_STAR_OUT_SCHEMA,
                      stage="dim3_join"))

    q_rev = (joined(fact_r)
             .repartition(stage="qual_part")
             .filter(_star_pred)
             .select("value")
             .reduce_by_key("sum", stage="star_agg"))
    q_all = joined(fact_r).reduce_by_key("sum", stage="star_agg")
    return q_rev, q_all


def _star_expect(fact: np.ndarray, dims) -> Tuple[dict, dict]:
    """numpy's grouped sums of value by a1: over rows whose a2 < 5
    (q_star_rev) and over all rows (q_star_all)."""
    attr = []
    for t in dims:
        a = np.zeros(int(t[:, 1].max()) + 1, np.int64)
        live = t[:, 1] != 0
        a[t[live, 1]] = t[live, 2]
        attr.append(a)
    a1 = attr[0][fact[:, 1]]
    a2 = attr[1][fact[:, 2]]
    rev = a2 < 5
    return (_grouped(a1[rev], fact[rev, 4]), _grouped(a1, fact[:, 4]))


def run_star_suite(
    manager: ShuffleManager,
    fact_rows_per_device: int = 128,
    scale: int = 1,
    seed: int = 0,
    executor=None,
    verify: bool = True,
) -> StarResult:
    """Star-schema multi-join suite: two planner-run queries sharing one
    repartitioned fact table, where all four rewrites fire:

    - both queries chain three DIMENSION joins off the shared
      ``star_fact`` repartition; the second query's fact exchange adopts
      the first's output (``plan.reuse_hits``);
    - the dims are small, so every join BROADCASTS
      (``plan.broadcast_joins``);
    - they are deferred host tables, so their encode OVERLAPS the fact
      exchange (``plan.overlapped_stages``);
    - ``q_star_rev`` writes filter + ``select("value")`` AFTER its
      pre-aggregate repartition; the pushdown pass sinks both below it
      (``plan.pushdown_sunk``).

    Word layout (key_words=2, val_words=4 — required):

      fact:         key=d1k, payload=(d2k, d3k, value, 0)
      after join 1 (key_from=0, attr_to=3): key=d2k, p=(d2k, d3k, value, a1)
      after join 2 (key_from=1, attr_to=0): key=d3k, p=(a2, d3k, value, a1)
      after join 3 (key_from=3, attr_to=1): key=a1,  p=(a2, a3, value, a1)

    Both queries are checked against numpy."""
    if manager.conf.val_words != 4:
        raise ValueError(
            f"run_star_suite needs val_words=4 (W=6) for the 3-join "
            f"chain; manager has val_words={manager.conf.val_words}")
    fact, *dims = _star_tables(manager.runtime.num_partitions,
                               fact_rows_per_device, scale, seed)
    t0 = time.perf_counter()
    q_rev, q_all = _star_plans(manager, fact, dims, scale, seed)
    ex = executor or PlanExecutor(manager)
    rev = ex.run(q_rev, job_name=f"star_rev_s{scale}")
    barrier(rev.records)
    alls = ex.run(q_all, job_name=f"star_all_s{scale}")
    barrier(alls.records)
    suite_s = time.perf_counter() - t0

    def groups_of(ds) -> Dict[int, int]:
        rows = ds.to_host_rows()
        return _grouped(rows[:, 1], rows[:, 4])

    rev_g, all_g = groups_of(rev), groups_of(alls)
    verified = None
    if verify:
        ref_rev, ref_all = _star_expect(fact, dims)
        verified = rev_g == ref_rev and all_g == ref_all
    return StarResult(
        fact_rows=fact.shape[0],
        rev_groups=len(rev_g), rev_total=sum(rev_g.values()),
        all_groups=len(all_g), all_total=sum(all_g.values()),
        suite_s=suite_s, verified=verified)


__all__ = ["run_q64_shape", "run_q95_shape", "run_star_suite",
           "QueryResult", "Q95Result", "StarResult"]
