"""TPC-H ``lineitem.l_orderkey`` in ``l_shipdate`` order (TPC-H v3 §4.2.3).

A job is the lines of a contiguous run of orders, read by map tasks that
scan ``lineitem`` by ship date:

1. an offset into the scale factor's order indices (1.5e9 at SF1000);
2. each order a uniform 1-7 lines and an ``o_orderdate`` uniform over the
   spec's 2,406 days ([1992-01-01, 1998-12-31 - 151 days]); the run ends
   at ``n`` lines, so its last order may lose its surplus lines;
3. each line ``o_orderdate`` + a uniform 1-121 days (``l_shipdate``);
4. the lines ordered by ship day, stably in generation order within a day;
5. each line's key the sparse ``o_orderkey`` of its order: of every 32
   keys the first 8 are used (dbgen's ``mk_sparse``, order index ``i``
   from 1: ``(i >> 3) << 5 | i & 7``).

Key word 0 holds the key's high 32 bits and word 1 its low 32 bits, so
the words in order compare as the int64 key does. Device operations only,
no host sync, int32 keys. Its transient memory (5.5 GB at 2^27 lines) stays
under what the program's job holds, so that a run's peak is the program's.
"""

import torch


def lines(n, gen, device, orders, max_lines, order_days, ship_days):
    """``(order, ship)``: each of the job's ``n`` lines in ship-date order,
    its order's index from 1 (int32) and its ship day (int16, days after
    the first order day). The mix gives the scale factor's ``orders``,
    an order's ``max_lines``, the ``order_days`` its date is drawn from and
    the ``ship_days`` its lines ship within."""
    # orders the run may need: the mean is n / 4 lines-per-order; the
    # margin of 4 sqrt(n) orders is 16 standard deviations of their lines
    mean = (1 + max_lines) / 2
    m = int(n / mean + 4 * n ** 0.5) + 64
    first = torch.randint(0, orders - m, (1,), generator=gen,
                          dtype=torch.int64, device=device)
    count = torch.randint(1, max_lines + 1, (m,), generator=gen,
                          dtype=torch.int32, device=device)
    odate = torch.randint(0, order_days, (m,), generator=gen,
                          dtype=torch.int16, device=device)
    # line p belongs to the last order starting at or before p: a 1 at each
    # order's first line, summed along the lines; the run stops at n lines
    start = torch.cumsum(count, 0, dtype=torch.int32) - count
    mark = torch.zeros(n + 1, dtype=torch.int32, device=device)
    mark[start.clamp_(max=n)] = 1
    order = torch.cumsum(mark[:n], 0, dtype=torch.int32).sub_(1)
    ship = torch.randint(1, ship_days + 1, (n,), generator=gen,
                         dtype=torch.int16, device=device)
    ship += odate[order]
    day, by_day = torch.sort(ship, stable=True)
    # the order's index from 1 stays under 2^31: int32 throughout
    g = order[by_day]
    g += (first + 1).to(torch.int32)
    return g, day


def generate(n, words, gen, device, **params):
    """``int32[2, n]``: the lines' ``l_orderkey`` (``lines``'s parameters)."""
    if words != 2:
        raise ValueError("l_orderkey takes two key words")
    g = lines(n, gen, device, **params)[0]
    out = torch.empty((2, n), dtype=torch.int32, device=device)
    # key >> 32 is g >> 30; key mod 2^32 is (g & ~7) << 2 | g & 7, the
    # shift dropping g's bit 30 as a uint32 shift would
    torch.bitwise_right_shift(g, 30, out=out[0])
    torch.bitwise_left_shift(g & -8, 2, out=out[1])
    out[1] |= g & 7
    return out
