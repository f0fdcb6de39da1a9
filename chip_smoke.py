#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
started together), holds each against its plain PyTorch version, then
drives the port's three paths:

* the paper's TPC-H cursor loops Q2, Q13, Q18 and Q21 in Aggify+ form at
  scale factor 10 on both grouped routes, every result checked against a
  numpy oracle;
* the Mamba-2 LM (``mamba2-2.7b`` at full width and depth, random weights
  from a seed): ``LM.prefill`` through the SSD-scan kernel at the
  ``prefill_32k`` sequence length, and the continuous-batching ``Server``,
  held against the plain route, the float64 scan oracle, the step-by-step
  decode and a bf16 noise floor measured in the same run;
* the flash-decode kernel through ``kernels.ops.decode_attention`` — on
  the reference sweep, on the KV caches of ``qwen3-14b`` (the dense family
  at full width and depth, random weights from a seed) served by the same
  ``Server`` (40 captured decode-attention calls of one step, held against
  the output the model used), on each layer's flash-prefill q, k, v at 4
  float32 layers (held against flash's rows), and at the ``decode_32k``
  shape beside one ``scaled_dot_product_attention`` call.

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
            "segagg_sorted": "src/repro/kernels/segment_agg.py:304",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:39",
            "decode_attn": "src/repro/kernels/decode_attn.py:38"}
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
DECODE_SOURCE = "src/repro_torch/csrc/decode_attn.cu"
#: float32 rate of one H100 SXM's CUDA cores (NVIDIA data sheet): the peak
#: the SSD kernel's arithmetic can use, all of it float32 by contract
F32_FLOPS_PER_S = 67e12
LM_ARCH = "mamba2-2.7b"
#: the main path's prefill: the prefill_32k sequence length, batch cut
#: from 32 to 2 so one layer's activations fit the card's 80 GB
PREFILL_BATCH, PREFILL_SEQ = 2, 32768
LM_CHUNK = 128      # the launcher's ssd_chunk at full size
DENSE_ARCH = "qwen3-14b"


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


# ---------------------------------------------------------------------------
# The LM path: the SSD-scan kernel, alone and inside mamba2-2.7b
# ---------------------------------------------------------------------------


def rel_err(torch, got, want) -> float:
    """Relative Frobenius error of ``got`` against ``want``, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def ssd_bound(x, log_a, b, c, chunk) -> tuple[float, float, str]:
    """(bound ms, float32 flops, what bounds it) of one SSD scan: x, log_a,
    B and C read once and y written once over the HBM rate, against the
    float32 flops the function needs over the float32 cores' rate.  Per
    chunk: the scores C·Bᵀ over the causal s <= t pairs once per B/C row
    (shared by the heads that share the row), and per batch-head scores·x
    over the same pairs, C·h and the state update over all of N x P."""
    bh, t, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    nbytes = sum(v.numel() * v.element_size() for v in (x, log_a, b, c)) \
        + x.numel() * x.element_size()
    tri, chunks = chunk * (chunk + 1) // 2, t // chunk
    flops = g * chunks * 2 * tri * n \
        + bh * chunks * (2 * tri * p + 4 * chunk * n * p)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, flops,
            "bytes" if t_bytes >= t_ops else "operations")


def ssd_compare(torch, ss, args, chunk, label: dict, reps=3) -> dict:
    """Kernel against plain version on the same inputs.  Gate: relative
    error <= 1e-3 — the two differ only in the order of float32 sums, and
    y's last rounding to bf16 may flip an element by one ulp (2^-8).
    Times both by CUDA events."""
    got = ss.ssd_scan(*args, chunk=chunk, backend="auto")
    want = ss.ssd_scan(*args, chunk=chunk, backend="plain")
    torch.cuda.synchronize()
    err = rel_err(torch, got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"ssd_scan {label}: non-finite y")
    check(err <= 1e-3, f"ssd_scan {label}: kernel vs plain rel_err {err}")
    del got, want
    ms = cuda_ms(torch, lambda: ss.ssd_scan(*args, chunk=chunk,
                                            backend="auto"), reps)
    plain = cuda_ms(torch, lambda: ss.ssd_scan(*args, chunk=chunk,
                                               backend="plain"), 2)
    bound, flops, by = ssd_bound(*args, chunk)
    x, b = args[0], args[2]
    torch.cuda.empty_cache()
    return {"kernel": "ssd_scan", **label, "bh": x.shape[0],
            "steps": x.shape[1], "p": x.shape[2], "n": b.shape[-1],
            "chunk": chunk, "dtype": str(x.dtype).replace("torch.", ""),
            "bc_rows": b.shape[0], "rel_err": err, "gate": 1e-3,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "flops": flops}


def ssd_phases(torch, ss, ref) -> None:
    """The kernel at the main path's shape (B = 2, H = 80, T = 32768,
    P = 64, N = 128) in bf16 and float32, chunk 64 and 128, with B/C shared
    by the heads and broadcast to every head; then float32 against the
    float64 sequential oracle at T = 1024 (gate 1e-4)."""
    b_sz, heads, t, p, n = PREFILL_BATCH, 80, PREFILL_SEQ, 64, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        x = rnd((b_sz * heads, t, p), 0.5, dtype)
        log_a = -rnd((b_sz * heads, t), 0.1, torch.float32).abs()
        b, c = rnd((b_sz, t, n), 0.3, dtype), rnd((b_sz, t, n), 0.3, dtype)
        for layout in ("shared", "broadcast"):
            bc = (b, c) if layout == "shared" else \
                (b.repeat_interleave(heads, 0), c.repeat_interleave(heads, 0))
            for chunk in (64, 128):
                emit({"phase": "kernel_vs_plain",
                      **ssd_compare(torch, ss, (x, log_a, *bc), chunk,
                                    {"bc": layout})})
            del bc
        del x, log_a, b, c
        torch.cuda.empty_cache()

    bh, t = b_sz * heads, 1024
    x = rnd((bh, t, p), 0.5, torch.float32)
    log_a = -rnd((bh, t), 0.1, torch.float32).abs()
    b = rnd((b_sz, t, n), 0.3, torch.float32)
    c = rnd((b_sz, t, n), 0.3, torch.float32)
    want = ref.ssd_scan_ref(x.double(), log_a.double(), b.double(),
                            c.double())
    for chunk in (64, 128):
        err = rel_err(torch, ss.ssd_scan(x, log_a, b, c, chunk=chunk), want)
        check(err <= 1e-4, f"ssd_scan vs float64 oracle, chunk {chunk}: "
                           f"rel_err {err}")
        emit({"phase": "kernel_vs_oracle", "kernel": "ssd_scan", "bh": bh,
              "steps": t, "p": p, "n": n, "chunk": chunk,
              "dtype": "float32", "oracle": "float64 sequential",
              "rel_err": err, "gate": 1e-4})
    del x, log_a, b, c, want
    torch.cuda.empty_cache()


class SsdClock:
    """Wraps the model's call of ``kernels.ssd_scan`` with CUDA events, and
    keeps the arguments of the first call while ``capture`` is set."""

    def __init__(self, torch, ssm_mod):
        self.torch, self.mod, self.fn = torch, ssm_mod, ssm_mod.ssd_scan
        self.events, self.capture, self.captured = [], False, None

        def timed(*a, **kw):
            if self.capture and self.captured is None:
                self.captured = (a, kw)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.fn(*a, **kw)
            e.record()
            self.events.append((s, e))
            return out
        ssm_mod.ssd_scan = timed

    def read_ms(self) -> float:
        self.torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        self.events.clear()
        return ms

    def close(self):
        self.mod.ssd_scan = self.fn


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def lm_prefill(torch, ss, sa, lm, params, toks, cfg, ssm_mod):
    """The main path: ``LM.prefill`` at full width and depth, twice, with
    every launch count set to 0 just before each run and read just after.
    Returns (launches of the last run, the kernel against its plain
    version on the first layer's captured inputs)."""
    clock = SsdClock(torch, ssm_mod)
    try:
        for run in range(2):
            ss.ssd_scan_cuda.launches = 0
            sa.segagg_sorted.launches = sa.segagg_unsorted.launches = 0
            clock.capture = run == 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, _ = lm.prefill(params, toks)
            torch.cuda.synchronize()
            lat = (time.perf_counter() - t1) * 1e3
            ssd_ms = clock.read_ms()
            launches = ss.ssd_scan_cuda.launches
            check(launches == cfg.n_layers,
                  f"lm_prefill: {launches} ssd_scan launches, want "
                  f"{cfg.n_layers}")
            check(sa.segagg_sorted.launches + sa.segagg_unsorted.launches
                  == 0, "lm_prefill launched a segment kernel")
            check(tuple(logits.shape) == (PREFILL_BATCH, lm.vocab_padded)
                  and bool(torch.isfinite(logits).all()),
                  "lm_prefill: logits not finite or of the wrong shape")
            del logits
            emit({"phase": "lm_prefill", "run": run,
                  "batch": PREFILL_BATCH, "seq": PREFILL_SEQ,
                  "chunk": lm.ssd_chunk, "latency_ms": lat,
                  "tokens_per_s": PREFILL_BATCH * PREFILL_SEQ / lat * 1e3,
                  "ssd_ms": ssd_ms, "ssd_share": ssd_ms / lat,
                  "launches": {"ssd_scan": launches},
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        clock.close()
    a, kw = clock.captured
    cap = ssd_compare(torch, ss, a[:4], kw["chunk"], {"layer": 0})
    emit({"phase": "main_path_kernel", **cap})
    return launches, cap


def teacher_forced_margin(torch, lm, params, reqs) -> float:
    """Feeds each served request's prompt and tokens through batch-1
    ``decode_step`` from an empty cache; returns the worst margin
    (logit of the served token − the top logit) / max |logit| over every
    served token.  ≥ 0 where each token is the argmax."""
    worst = float("inf")
    for r in reqs:
        cache = lm.init_cache(1, 128)
        for i, tok in enumerate(r.prompt + r.out[:-1]):
            lg, cache = lm.decode_step(params, cache,
                                       torch.tensor([[tok]], device="cuda"))
            j = i - (len(r.prompt) - 1)
            if j >= 0:
                lg = lg[0]
                margin = (float(lg[r.out[j]]) - float(lg.max())) \
                    / float(lg.abs().max())
                worst = min(worst, margin)
    return worst


def lm_phases(torch, ss, sa) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.models import LM
    from repro_torch.models import blocks as B
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import embed
    from repro_torch.models.model import layer

    cfg = get_config(LM_ARCH)
    check(SHAPES["prefill_32k"].seq_len == PREFILL_SEQ, "prefill_32k moved")
    lm = LM(cfg, ssd_chunk=LM_CHUNK)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    flags = torch.backends
    emit({"phase": "lm_init", "arch": LM_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_inner": cfg.ssm_expand * cfg.d_model,
          "heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
          "ssm_state": cfg.ssm_state, "vocab_padded": lm.vocab_padded,
          "params": n_params, "param_count_analytic": cfg.param_count(),
          "bytes": 2 * n_params, "dtype": "bfloat16",
          "seconds": time.perf_counter() - t0,
          "backend": {
              "cuda.matmul.allow_tf32": flags.cuda.matmul.allow_tf32,
              "cuda.matmul.allow_bf16_reduced_precision_reduction":
                  flags.cuda.matmul.allow_bf16_reduced_precision_reduction,
              "cudnn.allow_tf32": flags.cudnn.allow_tf32}})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                         generator=gen, device="cuda")

    # one SSM block's sublayer output h, kernel against plain route (gate
    # 1e-2: the scan's bf16 y, rounded apart in a few elements, passes
    # through the skip, the gate, the norm and the output projection)
    lp = layer(params["blocks"], 0)
    xn = B._norm(cfg, lp, embed(params["embed"], toks).to(lm.dtype), "norm1")
    kw = dict(state=cfg.ssm_state, headdim=cfg.ssm_headdim,
              expand=cfg.ssm_expand, chunk=LM_CHUNK)
    h_k = ssm_mod.ssm_layer(lp["ssm"], xn, backend="auto", **kw)
    h_p = ssm_mod.ssm_layer(lp["ssm"], xn, backend="plain", **kw)
    err = rel_err(torch, h_k, h_p)
    check(err <= 1e-2, f"lm_layer: kernel vs plain rel_err {err}")
    emit({"phase": "lm_layer", "tokens": list(toks.shape),
          "dtype": "bfloat16", "chunk": LM_CHUNK,
          "rel_err_kernel_vs_plain": err, "gate": 1e-2})
    del lp, xn, h_k, h_p
    torch.cuda.empty_cache()

    launches, cap = lm_prefill(torch, ss, sa, lm, params, toks, cfg, ssm_mod)
    torch.cuda.empty_cache()

    # bf16 end to end: the kernel's gap against the chunk-size noise floor
    # of the plain route on the same tokens (gate: gap <= 3 x floor)
    toks4k = toks[:1, :4096]
    outs = {}
    for name, backend, chunk in (("kernel128", "auto", 128),
                                 ("plain128", "plain", 128),
                                 ("plain64", "plain", 64)):
        lm.ssd_backend, lm.ssd_chunk = backend, chunk
        outs[name] = lm.forward(params, toks4k)[0]
    lm.ssd_backend, lm.ssd_chunk = "auto", LM_CHUNK
    gap = rel_err(torch, outs["kernel128"], outs["plain128"])
    floor = rel_err(torch, outs["plain64"], outs["plain128"])
    check(gap <= 3 * floor, f"lm_bf16_end_to_end: kernel gap {gap} > 3 x "
                            f"noise floor {floor}")
    emit({"phase": "lm_bf16_end_to_end", "tokens": [1, 4096],
          "rel_err_kernel_vs_plain": gap,
          "noise_floor_plain_chunk64_vs_128": floor,
          "gate": "gap <= 3 x floor"})
    del outs
    torch.cuda.empty_cache()

    # serving in bf16: the launcher's LM workload
    reqs = make_requests(cfg.vocab, 8, 16)
    res = serve_requests(lm, params, reqs, slots=4, max_len=128)
    check(res["done"] == 8 and all(len(r.out) == 16 for r in reqs),
          f"lm_serve: {res['done']}/8 requests done")
    emit({"phase": "lm_serve", "dtype": "bfloat16", "slots": 4,
          "requests": 8, "done": res["done"], "steps": res["steps"],
          "prompt_lens": [len(r.prompt) for r in reqs], "max_new": 16,
          "tokens": res["tokens"], "seconds": res["seconds"],
          "tokens_per_s": res["tokens"] / res["seconds"]})

    # float32 at full width and depth: the same weights, widened
    params32 = _tree_map(lambda v: v.float(), params)
    del params
    torch.cuda.empty_cache()
    lm32 = LM(cfg, ssd_chunk=LM_CHUNK, dtype=torch.float32)
    k32 = lm32.forward(params32, toks4k)[0]
    lm32.ssd_backend = "plain"
    p32 = lm32.forward(params32, toks4k)[0]
    lm32.ssd_backend = "auto"
    err_route = rel_err(torch, k32, p32)
    check(err_route <= 1e-4, f"lm_f32: kernel vs plain route {err_route}")
    del k32, p32
    prompt = toks4k[:, :256]
    last, _ = lm32.prefill(params32, prompt)
    cache = lm32.init_cache(1, 256)
    for i in range(prompt.shape[1]):
        step, cache = lm32.decode_step(params32, cache, prompt[:, i:i + 1])
    # decode masks the pad vocab to -1e30, prefill does not: real vocab only
    err_dec = rel_err(torch, step[:, :cfg.vocab], last[:, :cfg.vocab])
    check(err_dec <= 1e-3, f"lm_f32: prefill vs step-by-step decode "
                           f"{err_dec}")
    emit({"phase": "lm_f32", "tokens": [1, 4096],
          "rel_err_kernel_vs_plain_route": err_route, "gate_route": 1e-4,
          "decode_prompt": 256, "rel_err_prefill_vs_decode": err_dec,
          "gate_decode": 1e-3})
    del cache, step, last

    # serving in float32; every served token against batch-1 decode
    reqs = make_requests(cfg.vocab, 8, 16)
    res = serve_requests(lm32, params32, reqs, slots=4, max_len=128)
    check(res["done"] == 8 and all(len(r.out) == 16 for r in reqs),
          f"lm_serve f32: {res['done']}/8 requests done")
    worst = teacher_forced_margin(torch, lm32, params32, reqs)
    check(worst >= -1e-4, f"lm_serve f32: a served token is not the "
                          f"batch-1 argmax (margin {worst})")
    emit({"phase": "lm_serve", "dtype": "float32", "slots": 4,
          "requests": 8, "done": res["done"], "steps": res["steps"],
          "tokens": res["tokens"], "seconds": res["seconds"],
          "tokens_per_s": res["tokens"] / res["seconds"],
          "teacher_forced_worst_margin": worst, "gate": -1e-4})
    del params32
    torch.cuda.empty_cache()
    return {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
            "replaces": REPLACES["ssd_scan"], "launches": launches,
            "max_abs_err": cap["max_abs_err"], "ms": cap["ms"],
            "plain_ms": cap["plain_ms"], "bound_ms": cap["bound_ms"],
            "bound_by": cap["bound_by"], "library_ms": None}


# ---------------------------------------------------------------------------
# The dense path: the flash-decode kernel, alone, on qwen3-14b's own caches
# and at decode_32k
# ---------------------------------------------------------------------------


def decode_bound(kv_len, s, g, d, esize) -> tuple[float, float, str]:
    """(bound ms, float32 flops, what bounds it) of one decode-attention
    call: K and V up to each row's kv_len read once, q and kv_len read
    once and out written once over the HBM rate, against 4·G·D flops per
    attended position (q·k and p·v) over the float32 cores' rate."""
    attended = int(kv_len.clamp(0, s).sum())
    bh = kv_len.numel()
    nbytes = 2 * attended * d * esize + 2 * bh * g * d * esize + 4 * bh
    flops = 4.0 * g * d * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, flops,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_inputs(torch, seed, bh, g, d, s, dtype, lens=None):
    """q, k, v standard normal in ``dtype`` and kv_len uniform in [1, S]
    (or ``lens``), made on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
               for shape in ((bh, g, d), (bh, s, d), (bh, s, d)))
    if lens is None:
        lens = torch.randint(1, s + 1, (bh,), generator=gen, device="cuda")
    return q, k, v, torch.as_tensor(lens, device="cuda").to(torch.int32)


def decode_sweep(torch, da, ref) -> None:
    """The kernel against its plain version (relative Frobenius error
    <= 1e-5 in float32, <= 5e-3 in bf16) and against the float32 oracle
    (elementwise 2e-5 / 4e-2, the reference sweep's, on the rows with
    kv_len >= 1), on the reference sweep's shapes and qwen3-14b's group
    with S = 4096 + 77 and kv_len in {0, 1, 127, 128, 129, S}; kv_len = 0
    rows exactly zero."""
    s_q = 4096 + 77
    shapes = [(2, 8, 128, 256, None), (1, 16, 128, 300, None),
              (4, 8, 256, 512, None),
              (6, 5, 128, s_q, [0, 1, 127, 128, 129, s_q])]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        gate = 1e-5 if dtype == torch.float32 else 5e-3
        tol = 2e-5 if dtype == torch.float32 else 4e-2
        for i, (bh, g, d, s, lens) in enumerate(shapes):
            q, k, v, kv_len = decode_inputs(torch, SEED + 20 + i, bh, g, d,
                                            s, dtype, lens)
            got = da.decode_attention(q, k, v, kv_len)
            want = da.decode_attention(q, k, v, kv_len, backend="plain")
            oracle = ref.decode_attention_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = rel_err(torch, got, want)
            check(err <= gate, f"decode_attn {name} {(bh, g, d, s)}: "
                               f"kernel vs plain rel_err {err}")
            live = kv_len > 0
            gl, ol = got[live].float(), oracle[live].float()
            excess = float(((gl - ol).abs() - tol * (1 + ol.abs())).max())
            check(excess <= 0, f"decode_attn {name} {(bh, g, d, s)}: kernel "
                               "vs oracle past the elementwise gate")
            check(bool((got[~live] == 0).all()),
                  "decode_attn: a kv_len = 0 row is not zero")
            shape = {"kernel": "decode_attn", "bh": bh, "g": g, "d": d,
                     "s": s, "kv_len": kv_len.tolist(), "dtype": name,
                     "split": da.default_split(bh, s),
                     "tile": da.tile_rows(d, q.element_size())}
            emit({"phase": "kernel_vs_plain", **shape, "rel_err": err,
                  "gate": gate,
                  "max_abs_err": float((got.float() - want.float()).abs()
                                       .max())})
            emit({"phase": "kernel_vs_oracle", **shape,
                  "oracle": "float32 softmax",
                  "max_abs_err": float((gl - ol).abs().max()),
                  "gate": f"|err| <= {tol} (1 + |oracle|)"})
    torch.cuda.empty_cache()


def kernel_layout(q, kc, vc, lens):
    """The model's decode-attention arguments, q (B, H, D), caches (B, S,
    Hkv, D) and kv_len (B,), in the kernel's layout: (B·Hkv, G, D), (B·Hkv,
    S, D) and (B·Hkv,)."""
    b, h, d = q.shape
    hkv = kc.shape[2]
    return (q.reshape(b * hkv, h // hkv, d).contiguous(),
            kc.permute(0, 2, 1, 3).reshape(b * hkv, -1, d).contiguous(),
            vc.permute(0, 2, 1, 3).reshape(b * hkv, -1, d).contiguous(),
            lens.repeat_interleave(hkv).to(lens.dtype))


class Capture:
    """Wraps ``owner.attr`` (a function of the model) so the calls with
    index in ``keep`` record their arguments and output; restores it on
    ``close``."""

    def __init__(self, owner, attr, keep):
        self.owner, self.attr, self.fn = owner, attr, getattr(owner, attr)
        self.calls, self.count, self.keep = [], 0, keep

        def wrapped(*a, **kw):
            out = self.fn(*a, **kw)
            if self.count in self.keep:
                self.calls.append((a, out))
            self.count += 1
            return out
        setattr(owner, attr, wrapped)

    def close(self):
        setattr(self.owner, self.attr, self.fn)


def zero_counts(sa, ss, da) -> None:
    sa.segagg_sorted.launches = sa.segagg_unsorted.launches = 0
    ss.ssd_scan_cuda.launches = da.decode_attention_cuda.launches = 0


def read_counts(sa, ss, da) -> dict:
    return {"segagg_sorted": sa.segagg_sorted.launches,
            "segagg_unsorted": sa.segagg_unsorted.launches,
            "ssd_scan": ss.ssd_scan_cuda.launches,
            "decode_attn": da.decode_attention_cuda.launches}


def dense_serve(torch, sa, ss, da, lm, params, cfg) -> int:
    """The launcher's LM workload in bf16 (4 slots, 8 requests, 16 new
    tokens each).  The served decode runs the model's plain
    ``decode_attention_jnp`` (no kernel launch, as in the reference); the
    40 calls of one mid-run step are captured and fed to
    ``ops.decode_attention``, with every count set to 0 just before and
    read just after: kernel vs plain version <= 5e-3, kernel vs the output
    the model used <= 1e-2, 40 launches.  Returns those launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.models import attention

    step = 24
    cap = Capture(attention, "decode_attention_jnp",
                  range(step * cfg.n_layers, (step + 1) * cfg.n_layers))
    reqs = make_requests(cfg.vocab, 8, 16)
    zero_counts(sa, ss, da)
    try:
        res = serve_requests(lm, params, reqs, slots=4, max_len=128)
    finally:
        cap.close()
    served = read_counts(sa, ss, da)
    check(res["done"] == 8 and all(len(r.out) == 16 for r in reqs),
          f"dense_serve: {res['done']}/8 requests done")
    check(not any(served.values()), f"dense_serve: the served decode "
                                     f"launched kernels {served}")
    check(len(cap.calls) == cfg.n_layers,
          f"dense_serve: captured {len(cap.calls)} calls")
    args = [(kernel_layout(*a), out) for a, out in cap.calls]
    zero_counts(sa, ss, da)
    outs = [ops.decode_attention(*ka) for ka, _ in args]
    torch.cuda.synchronize()
    counts = read_counts(sa, ss, da)
    check(counts["decode_attn"] == cfg.n_layers and
          sum(counts.values()) == cfg.n_layers,
          f"dense_serve: ops.decode_attention launched {counts}")
    err_plain = max(rel_err(torch, o, ref.decode_attention_chunked(*ka))
                    for o, (ka, _) in zip(outs, args))
    err_model = max(rel_err(torch, o, used.reshape(o.shape))
                    for o, (_, used) in zip(outs, args))
    check(err_plain <= 5e-3, f"dense_serve: kernel vs plain {err_plain}")
    check(err_model <= 1e-2, f"dense_serve: kernel vs the model's decode "
                             f"attention {err_model}")
    q, kc, _, eff = cap.calls[0][0]
    emit({"phase": "dense_serve", "dtype": "bfloat16", "slots": 4,
          "requests": 8, "done": res["done"], "steps": res["steps"],
          "prompt_lens": [len(r.prompt) for r in reqs], "max_new": 16,
          "tokens": res["tokens"], "seconds": res["seconds"],
          "launches_served": served, "captured_step": step,
          "captured_q": list(q.shape), "captured_cache": list(kc.shape),
          "captured_kv_len": eff.tolist(), "launches_ops": counts,
          "rel_err_kernel_vs_plain": err_plain, "gate_plain": 5e-3,
          "rel_err_kernel_vs_model": err_model, "gate_model": 1e-2})
    return counts["decode_attn"]


def dense_f32(torch, da, lm32, params32, cfg32) -> None:
    """Full width, 4 layers, float32, 1 x 4096 tokens: the kernel at
    kv_len = t + 1 on each layer's flash-prefill q, k, v equals flash's
    output row t (<= 1e-5: two implementations of one function); prefill
    against step-by-step decode (<= 1e-3); float32 serving, every served
    token the batch-1 teacher-forced argmax."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.models import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    toks = torch.randint(0, cfg32.vocab, (1, 4096), generator=gen,
                         device="cuda")
    cap = Capture(flash, "flash_attention", range(cfg32.n_layers))
    try:
        last, _ = lm32.prefill(params32, toks)
    finally:
        cap.close()
    rows = torch.tensor([0, 1, 1023, 1024, 2047, 4095], device="cuda")
    worst = 0.0
    for (q, k, v, *_), out in cap.calls:
        hkv, s = k.shape[2], k.shape[1]
        qk = q[0, rows]                                      # (6, H, D)
        kk = k[0].permute(1, 0, 2)[None].expand(len(rows), -1, -1, -1)
        vv = v[0].permute(1, 0, 2)[None].expand(len(rows), -1, -1, -1)
        got = ops.decode_attention(
            qk.reshape(len(rows) * hkv, -1, qk.shape[-1]).contiguous(),
            kk.reshape(len(rows) * hkv, s, -1).contiguous(),
            vv.reshape(len(rows) * hkv, s, -1).contiguous(),
            (rows + 1).repeat_interleave(hkv).to(torch.int32))
        worst = max(worst, rel_err(torch, got, out[0, rows].reshape(
            got.shape)))
    check(worst <= 1e-5, f"dense_f32: decode kernel vs flash rows {worst}")
    del cap

    prompt = toks[:, :256]
    last, _ = lm32.prefill(params32, prompt)
    cache = lm32.init_cache(1, 256)
    for i in range(prompt.shape[1]):
        step, cache = lm32.decode_step(params32, cache, prompt[:, i:i + 1])
    # decode masks the pad vocab to -1e30, prefill does not: real vocab only
    err_dec = rel_err(torch, step[:, :cfg32.vocab], last[:, :cfg32.vocab])
    check(err_dec <= 1e-3, f"dense_f32: prefill vs step-by-step decode "
                           f"{err_dec}")
    del cache, step, last

    reqs = make_requests(cfg32.vocab, 8, 16)
    res = serve_requests(lm32, params32, reqs, slots=4, max_len=128)
    check(res["done"] == 8 and all(len(r.out) == 16 for r in reqs),
          f"dense_f32 serve: {res['done']}/8 requests done")
    margin = teacher_forced_margin(torch, lm32, params32, reqs)
    check(margin >= -1e-4, f"dense_f32 serve: a served token is not the "
                           f"batch-1 argmax (margin {margin})")
    emit({"phase": "dense_f32", "layers": cfg32.n_layers,
          "tokens": [1, 4096], "q_chunk": lm32.q_chunk,
          "kv_chunk": lm32.kv_chunk, "rows": rows.tolist(),
          "rel_err_kernel_vs_flash": worst, "gate_flash": 1e-5,
          "decode_prompt": 256, "rel_err_prefill_vs_decode": err_dec,
          "gate_decode": 1e-3, "served_steps": res["steps"],
          "served_tokens": res["tokens"],
          "teacher_forced_worst_margin": margin, "gate_margin": -1e-4})


def sdpa_backend(torch, fn, want) -> str:
    """The SDPA backend whose output equals ``want`` (the default
    dispatch's) bit for bit, tried one backend at a time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                out = fn()
        except RuntimeError:
            continue
        if torch.equal(out, want):
            return name
    return "not identified"


def decode_32k(torch, da) -> dict:
    """ROADMAP B4's card shape: decode_32k (batch 128, S = 32768) at
    qwen3-14b's 8 KV heads, G = 5, D = 128, bf16, kv_len uniform in
    [1, S] from seed 0 and all S.  Kernel, plain version and one SDPA call
    (the library yardstick, never called by the port) timed by CUDA events
    (median of 5; the plain version of 3); the kernel against the plain
    version on the full shape (<= 5e-3) and against SDPA."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES

    shape = SHAPES["decode_32k"]
    bh, g, d, s = shape.global_batch * 8, 5, 128, shape.seq_len
    torch.cuda.reset_peak_memory_stats()
    q, k, v, uniform = decode_inputs(torch, SEED, bh, g, d, s, torch.bfloat16)
    line = None
    for label, kv_len in (("uniform", uniform),
                          ("full", torch.full_like(uniform, s))):
        got = da.decode_attention(q, k, v, kv_len)
        want = da.decode_attention(q, k, v, kv_len, backend="plain")
        mask = torch.arange(s, device="cuda")[None, None, None, :] \
            < kv_len[:, None, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                q.view(bh, 1, g, d), k.view(bh, 1, s, d),
                v.view(bh, 1, s, d), attn_mask=mask).view(bh, g, d)
        lib = sdpa()
        torch.cuda.synchronize()
        err = rel_err(torch, got, want)
        check(err <= 5e-3, f"decode_32k {label}: kernel vs plain {err}")
        err_lib = rel_err(torch, got, lib)
        max_abs = float((got.float() - want.float()).abs().max())
        backend = sdpa_backend(torch, sdpa, lib)
        del got, want, lib
        ms = cuda_ms(torch, lambda: da.decode_attention(q, k, v, kv_len), 5)
        plain = cuda_ms(torch, lambda: da.decode_attention(
            q, k, v, kv_len, backend="plain"), 3)
        lib_ms = cuda_ms(torch, sdpa, 5)
        bound, flops, by = decode_bound(kv_len, s, g, d, 2)
        row = {"phase": "decode_32k", "kv_len": label, "bh": bh, "g": g,
               "d": d, "s": s, "dtype": "bfloat16",
               "split": da.default_split(bh, s), "tile": da.tile_rows(d, 2),
               "attended": int(kv_len.sum()), "rel_err_kernel_vs_plain": err,
               "gate": 5e-3, "max_abs_err": max_abs,
               "rel_err_kernel_vs_sdpa": err_lib, "sdpa_backend": backend,
               "ms": ms, "plain_ms": plain, "sdpa_ms": lib_ms,
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        emit(row)
        del mask
        if label == "uniform":
            line = row
    del q, k, v
    torch.cuda.empty_cache()
    return line


def dense_phases(torch, sa, ss, da) -> dict:
    """qwen3-14b at full width and depth in bf16 (random init from seed 0
    on the card), served; then 4 of its layers widened to float32; then
    the decode_32k kernel phase with the model freed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(DENSE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    analytic = cfg.param_count()
    check(analytic == 14_768_291_840, f"dense_init: param_count {analytic}")
    # the analytic count leaves out the qk-norm and final-norm scales
    check(n_params == analytic + cfg.n_layers * 2 * cfg.head_dim
          + cfg.d_model, f"dense_init: {n_params} parameters")
    emit({"phase": "dense_init", "arch": DENSE_ARCH, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "d_ff": cfg.d_ff, "vocab_padded": lm.vocab_padded,
          "params": n_params, "param_count_analytic": analytic,
          "bytes": 2 * n_params, "dtype": "bfloat16",
          "seconds": time.perf_counter() - t0,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    launches = dense_serve(torch, sa, ss, da, lm, params, cfg)

    cfg32 = dataclasses.replace(cfg, n_layers=4)
    params32 = {"embed": _tree_map(lambda t: t.float(), params["embed"]),
                "final_norm": params["final_norm"].float(),
                "blocks": _tree_map(lambda t: t[:4].float(),
                                    params["blocks"])}
    del params
    torch.cuda.empty_cache()
    lm32 = LM(cfg32, dtype=torch.float32)
    dense_f32(torch, da, lm32, params32, cfg32)
    del params32
    torch.cuda.empty_cache()

    row = decode_32k(torch, da)
    return {"name": "decode_attn", "route": "cuda", "source": DECODE_SOURCE,
            "replaces": REPLACES["decode_attn"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["sdpa_ms"]}


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
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.layers import reference_numerics

    reference_numerics()
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
          "libraries": [build.library_path(n).name
                        for n in ("segment_agg", "ssd_scan",
                                  "decode_attn")]})

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

    cat, captured, launches = main_path(torch, sa)
    kernels = main_path_kernels(torch, sa, captured, launches)
    del cat, captured
    torch.cuda.empty_cache()

    ssd_phases(torch, ss, ref)
    kernels.append(lm_phases(torch, ss, sa))
    decode_sweep(torch, da, ref)
    kernels.append(dense_phases(torch, sa, ss, da))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
