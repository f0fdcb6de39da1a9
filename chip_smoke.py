#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
CUDA kernels from ``src/repro_torch/csrc``, holds each against its plain
PyTorch version, then runs the paper's TPC-H cursor loops Q2, Q13, Q18 and
Q21 in Aggify+ form at scale factor 10 on both grouped routes and checks
every result against a numpy oracle.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and the exit code is
nonzero.  Before the last line come the card's ``nvidia-smi`` name and
power limit and the ``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits 2 and prints no
result.  It imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: HBM rate of one H100 SXM (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
SCALE = 10          # TPC-H scale factor of the main path
SEED = 0
SOURCE = "src/repro_torch/csrc/segment_agg.cu"
REPLACES = {"segagg_unsorted": "src/repro/kernels/segment_agg.py:287",
            "segagg_sorted": "src/repro/kernels/segment_agg.py:304"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ---------------------------------------------------------------------------
# Timing and comparison helpers
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (after one warm-up),
    by CUDA events around each run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def exact_diff(torch, got, want) -> float:
    """Max |got - want| over the entries; raises unless every entry is
    equal, NaN where the other is NaN, with the same sign of zero."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(torch.equal(nan_g, nan_w), "NaN positions differ")
    fin = ~nan_g
    g, w = got[fin], want[fin]
    check(torch.equal(g, w), f"{int((g != w).sum())} entries differ")
    check(torch.equal(torch.signbit(g), torch.signbit(w)),
          "signs of zero differ")
    if g.numel() == 0:
        return 0.0
    return float(torch.where(g == w, 0.0, (g - w).abs()).max())


def bound_ms(n: int, num_cols: int, nrows: int, num_segments: int) -> float:
    """Least time for the bytes the function must move: vals and validity
    (N·C·(4+1)) and segment ids (4N) read once, the (C, R, S) f32 moment
    tensor written once, over the HBM rate."""
    nbytes = n * num_cols * 5 + 4 * n + num_cols * nrows * num_segments * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at main-path sizes
# ---------------------------------------------------------------------------


def synthetic_inputs(torch, n, num_segments, num_cols, sorted_segs, seed):
    """Integer-valued columns with NaN, -0.0 and ±inf planted, 10% invalid
    rows and every 7th segment empty — made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    segs = torch.randint(0, num_segments, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    segs = torch.where(segs % 7 == 3, segs + 1, segs).clamp(
        max=num_segments - 1)
    if sorted_segs:
        segs = torch.sort(segs).values
    vals = torch.randint(-50, 51, (n, num_cols), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.float32)
    u = torch.rand((n, num_cols), generator=g, device="cuda")
    vals = torch.where(u < 1e-4, float("nan"), vals)
    vals = torch.where((u >= 1e-4) & (u < 2e-4), -0.0, vals)
    vals = torch.where((u >= 2e-4) & (u < 3e-4), float("inf"), vals)
    vals = torch.where((u >= 3e-4) & (u < 4e-4), float("-inf"), vals)
    valid = torch.rand((n, num_cols), generator=g, device="cuda") < 0.9
    return vals.contiguous(), segs.contiguous(), valid.contiguous()


def kernel_vs_plain(torch, sa, name, n, num_segments, moments, sorted_segs,
                    seed, reps=5):
    kernel = getattr(sa, name)
    num_cols = len(moments)
    vals, segs, valid = synthetic_inputs(torch, n, num_segments, num_cols,
                                         sorted_segs, seed)
    norm = sa.normalize_moments(moments, num_cols)
    got = kernel(vals, segs, valid, num_segments, norm)
    want = sa.fused_segment_agg(vals, segs, valid, num_segments,
                                moments=norm, backend="jnp",
                                layout="sorted" if sorted_segs
                                else "unsorted")
    torch.cuda.synchronize()
    err = exact_diff(torch, got, want)
    nrows = sa.moment_rows(norm)
    del got, want
    ms = cuda_ms(torch, lambda: kernel(vals, segs, valid, num_segments,
                                       norm), reps)
    plain = cuda_ms(torch, lambda: sa._segment_agg_plain(
        vals, segs, valid, num_segments, norm, sorted_segs=sorted_segs), 3)
    row = {"phase": "kernel_vs_plain", "kernel": name, "rows": n,
           "segments": num_segments, "cols": num_cols, "moment_rows": nrows,
           "max_abs_err": err, "ms": ms, "plain_ms": plain,
           "bound_ms": bound_ms(n, num_cols, nrows, num_segments)}
    emit(row)
    del vals, segs, valid
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 3: the main path, against numpy oracles
# ---------------------------------------------------------------------------


def oracle(qname: str, host: dict):
    """(keys, values) of the grouped query over the host copy of the
    catalog, computed with numpy alone (bincount / lexsort)."""
    if qname == "Q2":
        ps = host["PARTSUPP"]
        s_name = host["SUPPLIER"]["s_name"]
        s_key = host["SUPPLIER"]["s_suppkey"]
        check(np.array_equal(s_key, np.arange(len(s_key))),
              "SUPPLIER keys are not dense")
        part, cost = ps["ps_partkey"], ps["ps_supplycost"]
        keys = np.unique(part)
        rows = np.nonzero(cost > np.float32(4.0))[0]   # the lb guard
        order = rows[np.lexsort((rows, cost[rows], part[rows]))]
        first = np.ones(len(order), bool)
        first[1:] = part[order][1:] != part[order][:-1]
        pick = order[first]
        name = np.full(keys.max() + 1, -1, np.int64)
        name[part[pick]] = s_name[ps["ps_suppkey"][pick]]
        return keys, name[keys]
    col, weight = {
        "Q13": ("o_custkey", lambda t: ~t["o_comment_special"]),
        "Q18": ("l_orderkey", lambda t: t["l_quantity"]),
        "Q21": ("l_suppkey",
                lambda t: t["l_receiptdate"] > t["l_commitdate"]),
    }[qname]
    t = host["ORDERS" if qname == "Q13" else "LINEITEM"]
    k = t[col]
    keys = np.unique(k)
    sums = np.bincount(k, weights=weight(t).astype(np.float64))
    return keys, sums[keys]


class PhaseClock:
    """Device time spent in the slotting, the sorts and the kernel launch
    of one grouped call: wraps those functions with CUDA events."""

    def __init__(self, torch, keyslot, segment_agg, table_cls):
        self.torch = torch
        self.events = {"slot": [], "sort": [], "kernel": []}
        self._restore = []
        self._wrap(keyslot, "slot_segment_ids", "slot")
        self._wrap(segment_agg, "fused_segment_agg", "kernel")
        self._wrap(table_cls, "sort_by", "sort")

    def _wrap(self, owner, attr, label):
        fn = getattr(owner, attr)
        torch, events = self.torch, self.events[label]

        def timed(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            events.append((s, e))
            return out
        setattr(owner, attr, timed)
        self._restore.append((owner, attr, fn))

    def read(self) -> dict:
        self.torch.cuda.synchronize()
        out = {k: sum((s.elapsed_time(e) for s, e in v), 0.0)
               for k, v in self.events.items()}
        for v in self.events.values():
            v.clear()
        return out

    def close(self):
        for owner, attr, fn in self._restore:
            setattr(owner, attr, fn)


def main_path(torch, sa, device="cuda"):
    from repro_torch.relational import execute, keyslot
    from repro_torch.relational.table import Table
    from repro_torch.relational.tpch import gen_tpch
    from repro_torch.workloads.tpch_queries import (QUERIES, grouped_call,
                                                    grouped_env)

    t0 = time.perf_counter()
    cat = gen_tpch(SCALE, seed=SEED, device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    emit({"phase": "tpch", "scale": SCALE, "seconds": gen_s,
          "rows": {k: t.capacity for k, t in cat.items()},
          "bytes": sum(t.nbytes() for t in cat.values())})
    host = {k: {c: v.cpu().numpy() for c, v in t.columns.items()}
            for k, t in cat.items()}

    kernels = {"sorted": sa.segagg_sorted, "sortfree": sa.segagg_unsorted}
    launches = {"segagg_sorted": 0, "segagg_unsorted": 0}
    captured = []                   # kernel inputs of each counted run
    clock = PhaseClock(torch, keyslot, sa, Table)
    timed_fsa = sa.fused_segment_agg

    def capture(*a, **kw):
        captured.append((a, kw))
        return timed_fsa(*a, **kw)
    try:
        for qname, (factory, _corr, key, domain) in QUERIES.items():
            env = grouped_env(qname, cat, device)
            want_keys, want_vals = oracle(qname, host)
            for route in ("sorted", "sortfree"):
                max_groups = cat[domain].capacity if route == "sortfree" \
                    else None
                call = grouped_call(factory(), key, max_groups=max_groups)
                for run in range(2):
                    for k in kernels.values():
                        k.launches = 0
                    sa.fused_segment_agg = capture if run == 0 else timed_fsa
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    res = execute(call, cat, env, device=device)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t1) * 1e3
                    counts = {r: k.launches for r, k in kernels.items()}
                    other = "sortfree" if route == "sorted" else "sorted"
                    check(counts[route] >= 1,
                          f"{qname} {route}: {kernels[route].__name__} "
                          "was not launched")
                    check(counts[other] == 0,
                          f"{qname} {route}: the other route's kernel ran")
                    launches[kernels[route].__name__] += counts[route]
                    phases = clock.read()
                    if run == 0:
                        got = res.to_numpy()
                        order = np.argsort(got[key], kind="stable")
                        gk = got[key][order]
                        term = [c for c in got if c != key]
                        check(len(term) == 1, f"{qname}: columns {term}")
                        gv = got[term[0]][order]
                        check(np.array_equal(gk, want_keys),
                              f"{qname} {route}: group keys differ")
                        check(np.array_equal(gv.astype(np.float64),
                                             want_vals.astype(np.float64)),
                              f"{qname} {route}: values differ from the "
                              "numpy oracle")
                        groups = len(gk)
                    del res
                    emit({"phase": "query", "query": qname, "route": route,
                          "run": run, "groups": groups, "wall_ms": wall_ms,
                          "slot_ms": phases["slot"],
                          "sort_ms": phases["sort"],
                          "kernel_ms": phases["kernel"],
                          "launches": counts, "oracle": "exact"})
    finally:
        clock.close()
    return cat, captured, launches


def main_path_kernels(torch, sa, captured, launches):
    """Time each main-path launch again from its captured inputs, kernel
    against plain version, and fold them into one line per kernel."""
    totals = {}
    for a, kw in captured:
        vals, segs, valid, num_segments = a
        layout = kw.get("layout", "sorted")
        name = "segagg_unsorted" if layout == "unsorted" else "segagg_sorted"
        norm = sa.normalize_moments(kw["moments"], vals.shape[1])
        v = vals.to(torch.float32).contiguous()
        s = segs.to(torch.int32).contiguous()
        ok = valid.to(torch.bool).contiguous()
        kernel = getattr(sa, name)
        got = kernel(v, s, ok, num_segments, norm)
        want = sa._segment_agg_plain(v, s, ok, num_segments, norm,
                                     sorted_segs=layout == "sorted")
        err = exact_diff(torch, got, want)
        del got, want
        ms = cuda_ms(torch, lambda: kernel(v, s, ok, num_segments, norm), 3)
        plain = cuda_ms(torch, lambda: sa._segment_agg_plain(
            v, s, ok, num_segments, norm, sorted_segs=layout == "sorted"), 2)
        nrows = sa.moment_rows(norm)
        b = bound_ms(v.shape[0], v.shape[1], nrows, num_segments)
        emit({"phase": "main_path_kernel", "kernel": name,
              "rows": v.shape[0], "cols": v.shape[1],
              "segments": num_segments, "moment_rows": nrows,
              "max_abs_err": err, "ms": ms, "plain_ms": plain,
              "bound_ms": b})
        t = totals.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                     "plain_ms": 0.0, "bound_ms": 0.0})
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += b
    out = []
    for name in ("segagg_unsorted", "segagg_sorted"):
        t = totals[name]
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": "bytes", "library_ms": None})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository (no "
              "src/repro_torch beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_agg as sa

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    check(torch.cuda.device_count() >= 1, "no CUDA device")

    secs, log = build.build_all()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "nvcc.log").write_text(log)
    emit({"phase": "build", "seconds": secs,
          "library": str(build.library_path("segment_agg").name)})

    value = ("sum", "count", "min", "max")
    index = (("argmin_first", "argmax_last", "sum", "count"),
             ("argmin_last", "argmax_first", "min"))
    kernel_vs_plain(torch, sa, "segagg_unsorted", 60_000_000, (1 << 17) + 1,
                    (value, value), False, seed=1)
    kernel_vs_plain(torch, sa, "segagg_unsorted", 8_000_000, (1 << 21) + 1,
                    index, False, seed=2)
    kernel_vs_plain(torch, sa, "segagg_sorted", 8_000_000, (1 << 21) + 1,
                    index, True, seed=3)
    kernel_vs_plain(torch, sa, "segagg_sorted", 60_000_000, 15_000_000,
                    (value, value), True, seed=4)

    _cat, captured, launches = main_path(torch, sa)
    kernels = main_path_kernels(torch, sa, captured, launches)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
