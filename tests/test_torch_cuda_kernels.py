"""The CUDA kernels on the card: the segment kernels against their plain
version bit for bit, the grouped TPC-H path on the card against the same
path on the CPU, and the SSD-scan kernel against its plain version and the
float64 sequential oracle, alone and inside the LM, and the split-KV
flash-decode kernel against its plain version and the float32 oracle,
alone and behind ``kernels.ops``.  Every test here needs a CUDA card and
skips without one; this file
imports neither ``jax`` nor ``repro``, so on a GPU machine it runs alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attn as da
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import LM
from repro_torch.models.layers import reference_numerics
from repro_torch.relational import Table, execute
from repro_torch.relational.tpch import gen_tpch
from repro_torch.workloads.tpch_queries import (QUERIES, grouped_call,
                                                grouped_env)

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card (the kernels have "
                                       "no CPU mode)")

VALUE = ("sum", "count", "min", "max")
INDEX = (("argmin_first", "argmax_last", "sum"),
         ("argmin_last", "argmax_first", "count"))


def _inputs(seed, n, s, sorted_segs):
    r = np.random.default_rng(seed)
    segs = r.integers(0, s, n).astype(np.int32)
    segs[segs % 5 == 2] += 1                     # empty segments
    segs = np.minimum(segs, s - 1)
    if sorted_segs:
        segs = np.sort(segs)
    vals = r.integers(-20, 20, (n, 2)).astype(np.float32)
    pick = r.random((n, 2))
    vals[pick < 0.01] = np.nan
    vals[(pick >= 0.01) & (pick < 0.02)] = -0.0
    vals[(pick >= 0.02) & (pick < 0.03)] = np.inf
    vals[(pick >= 0.03) & (pick < 0.04)] = -np.inf
    valid = r.random((n, 2)) < 0.9
    return [torch.as_tensor(x).cuda() for x in (vals, segs, valid)]


@pytest.mark.parametrize("moments", [VALUE, INDEX])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
@pytest.mark.parametrize("n,s", [(200_000, 5000), (100_000, 17),
                                 (3000, 100_000)])
def test_kernel_matches_plain_version(layout, moments, n, s):
    args = _inputs(n + s, n, s, layout == "sorted")
    got = sa.fused_segment_agg(*args, s, moments=moments, layout=layout)
    want = sa.fused_segment_agg(*args, s, moments=moments, layout=layout,
                                backend="jnp")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_launch_counts_and_checks():
    vals, segs, valid = _inputs(1, 1000, 50, sorted_segs=True)
    norm = sa.normalize_moments(VALUE, 2)
    before = sa.segagg_sorted.launches, sa.segagg_unsorted.launches
    sa.fused_segment_agg(vals, segs, valid, 50)
    sa.fused_segment_agg(vals, segs, valid, 50, layout="unsorted")
    assert (sa.segagg_sorted.launches, sa.segagg_unsorted.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="sorted ascending"):
        sa.fused_segment_agg(vals, segs.flip(0), valid, 50)
    with pytest.raises(ValueError, match="float32"):
        sa.segagg_unsorted(vals.double(), segs, valid, 50, norm)
    with pytest.raises(ValueError, match="contiguous"):
        sa.segagg_sorted(vals.t().contiguous().t(), segs, valid, 50, norm)


def test_entry_points_default_to_the_card():
    t = Table.from_columns(k=np.arange(4, dtype=np.int32))
    assert t.device.type == "cuda"


@pytest.mark.parametrize("qname", ["Q2", "Q13", "Q18", "Q21"])
def test_grouped_queries_on_the_card_match_the_cpu(qname):
    factory, _corr, key, domain = QUERIES[qname]
    out = {}
    for dev in ("cuda", "cpu"):
        cat = gen_tpch(0.002, seed=3, device=dev)
        for mg in (None, cat[domain].capacity):
            kernel = sa.segagg_sorted if mg is None else sa.segagg_unsorted
            before = kernel.launches
            res = execute(grouped_call(factory(), key, max_groups=mg), cat,
                          grouped_env(qname, cat, dev), device=dev)
            assert kernel.launches == before + (dev == "cuda")
            cols = res.to_numpy()
            order = np.argsort(cols[key], kind="stable")
            out[dev, mg is None] = {k: v[order] for k, v in cols.items()}
    for route in (True, False):
        for k, v in out["cpu", route].items():
            np.testing.assert_array_equal(out["cuda", route][k], v)


def _ssd_inputs(seed, bh, t, p, n, g, dtype):
    r = np.random.default_rng(seed)
    x = torch.as_tensor(r.standard_normal((bh, t, p)) * 0.5, dtype=dtype)
    log_a = torch.as_tensor(-np.abs(r.standard_normal((bh, t))) * 0.1,
                            dtype=torch.float32)
    b = torch.as_tensor(r.standard_normal((g, t, n)) * 0.3, dtype=dtype)
    c = torch.as_tensor(r.standard_normal((g, t, n)) * 0.3, dtype=dtype)
    return [v.cuda() for v in (x, log_a, b, c)]


def _rel(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,t,p,n,chunk", [
    (4, 4, 256, 64, 16, 32), (6, 2, 512, 64, 128, 128),
    (3, 1, 192, 48, 32, 64), (2, 2, 64, 16, 8, 8)])
def test_ssd_kernel_matches_plain_version(dtype, bh, g, t, p, n, chunk):
    """Same inputs, same float32 arithmetic in another summation order:
    relative Frobenius error <= 1e-5 in float32 and <= 1e-3 in bf16, where
    y's final bf16 rounding may flip an element by one ulp (2^-8)."""
    args = _ssd_inputs(t + p, bh, t, p, n, g, dtype)
    before = ss.ssd_scan_cuda.launches
    got = ss.ssd_scan(*args, chunk=chunk)
    assert ss.ssd_scan_cuda.launches == before + 1
    want = ss.ssd_scan(*args, chunk=chunk, backend="plain")
    assert ss.ssd_scan_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, t, p)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 1e-3)


def test_ssd_kernel_matches_the_float64_oracle():
    """float32 inputs against the sequential recurrence in float64: the
    kernel's own float32 rounding only, <= 1e-4 relative."""
    args = _ssd_inputs(9, 4, 512, 64, 128, 2, torch.float32)
    got = ss.ssd_scan(*args, chunk=128)
    want = ref.ssd_scan_ref(*(a.double() for a in args))
    assert _rel(got, want) <= 1e-4


def test_ssd_kernel_checks():
    x, log_a, b, c = _ssd_inputs(1, 2, 96, 16, 8, 2, torch.float32)
    with pytest.raises(ValueError, match="chunk=48"):
        ss.ssd_scan_cuda(x, log_a, b, c, 48)
    with pytest.raises(ValueError, match="share one dtype"):
        ss.ssd_scan_cuda(x, log_a, b.bfloat16(), c, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                         log_a, b, c, 32)
    with pytest.raises(ValueError, match="shared memory"):
        big = _ssd_inputs(1, 1, 256, 16, 128, 1, torch.float32)
        ss.ssd_scan_cuda(*big, 256)
    with pytest.raises(ValueError, match="multiples of 8"):
        ss.ssd_scan_cuda(*_ssd_inputs(1, 2, 64, 16, 12, 2, torch.bfloat16),
                         32)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)                  # contiguous, 4 bytes off a boundary
    with pytest.raises(ValueError, match="16-byte boundaries"):
        ss.ssd_scan_cuda(shifted, log_a, b, c, 32)


def test_lm_prefill_through_the_kernel():
    """The reduced LM on the card: one kernel launch per layer, and the
    kernel route equal to the plain route within float32 summation order."""
    reference_numerics()
    cfg = get_config("mamba2-2.7b").reduced()
    out = {}
    for backend in ("auto", "plain"):
        lm = LM(cfg, ssd_chunk=8, dtype=torch.float32, ssd_backend=backend)
        params = lm.init(torch.Generator(device="cuda").manual_seed(0))
        toks = torch.arange(2 * 37, device="cuda").reshape(2, 37) % cfg.vocab
        before = ss.ssd_scan_cuda.launches
        out[backend], _ = lm.prefill(params, toks)
        assert ss.ssd_scan_cuda.launches - before == \
            (cfg.n_layers if backend == "auto" else 0)
    assert _rel(out["auto"], out["plain"]) <= 1e-4


def _decode_inputs(seed, bh, g, d, s, dtype, lens=None):
    r = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(r.standard_normal(shape), dtype=dtype)
               for shape in ((bh, g, d), (bh, s, d), (bh, s, d)))
    if lens is None:
        lens = r.integers(1, s + 1, bh)
    return [t.cuda() for t in (q, k, v, torch.as_tensor(lens,
                                                        dtype=torch.int32))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,g,d,s,lens", [
    (2, 8, 128, 256, None), (1, 16, 128, 300, None), (4, 8, 256, 512, None),
    (6, 5, 128, 4173, [0, 1, 127, 128, 129, 4173]), (3, 4, 64, 40, None)])
def test_decode_kernel_matches_plain_version(dtype, bh, g, d, s, lens):
    """Against the plain version: relative Frobenius error <= 1e-5 in
    float32 (summation order) and <= 5e-3 in bf16 (a split's own running
    max rounds p to bf16 apart from the sequential one); against the
    float32 oracle elementwise at the reference sweep's 2e-5 / 4e-2 on the
    rows with kv_len >= 1; kv_len = 0 rows exactly zero."""
    q, k, v, kv_len = _decode_inputs(s + d, bh, g, d, s, dtype, lens)
    before = da.decode_attention_cuda.launches
    got = da.decode_attention(q, k, v, kv_len)
    assert da.decode_attention_cuda.launches == before + 1
    want = da.decode_attention(q, k, v, kv_len, backend="plain")
    assert da.decode_attention_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, g, d)
    assert _rel(got, want) <= (1e-5 if dtype == torch.float32 else 5e-3)
    live = kv_len > 0
    tol = 2e-5 if dtype == torch.float32 else 4e-2
    torch.testing.assert_close(got[live].float(),
                               ref.decode_attention_ref(q, k, v, kv_len)
                               [live].float(), rtol=tol, atol=tol)
    assert bool((got[~live] == 0).all())
    for split in (128, 384):
        again = da.decode_attention_cuda(q, k, v, kv_len, split)
        assert _rel(again, want) <= (1e-5 if dtype == torch.float32
                                     else 5e-3)


def test_decode_kernel_checks_and_ops_route():
    q, k, v, kv_len = _decode_inputs(0, 2, 8, 128, 64, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        da.decode_attention_cuda(q, k.bfloat16(), v, kv_len)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_cuda(q, k, v, kv_len.long())
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cuda(q, k.transpose(1, 2).contiguous()
                                 .transpose(1, 2), v, kv_len)
    with pytest.raises(ValueError, match="G="):
        da.decode_attention_cuda(*_decode_inputs(0, 1, 17, 128, 64,
                                                 torch.float32))
    with pytest.raises(ValueError, match="split"):
        da.decode_attention_cuda(q, k, v, kv_len, 100)
    before = da.decode_attention_cuda.launches
    got = ops.decode_attention(q, k, v, kv_len)
    assert da.decode_attention_cuda.launches == before + 1
    plain = ops.decode_attention(q, k, v, kv_len, use_pallas=False)
    assert da.decode_attention_cuda.launches == before + 1
    assert _rel(got, plain) <= 1e-5
