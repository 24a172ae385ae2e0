"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed. Inputs
are bf16 from seeded ``torch.Generator``s, at the serving path's widths and
at ragged shapes; outputs are compared at atol/rtol 2e-2 (a little over one
bf16 rounding step of the outputs, whose magnitudes stay below ~2). The
quantized kernels are held to their plain versions on the same codes and
scales: ``gemm_wq`` rounds each dequantized weight to bf16 once, as a bf16
weight is rounded, which stays inside the same tolerance. ``lru_scan`` is
float32 and is held at atol/rtol 1e-5: it does the plain version's rounded
multiply and add per step, in the same order. ``packed_gather_rows`` copies
rows and is held bit for bit (``torch.equal``).
"""
from __future__ import annotations

import itertools

import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemm_wq as twq
from repro_torch.kernels import lru_scan as tlru
from repro_torch.kernels import packed_gather as tpg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref
from repro_torch.quant import quantize_kv, quantize_weight


# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def _bf16(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,act", [(4, 1024, 3072, "silu"),
                                       (37, 200, 65, None),
                                       (64, 3072, 1024, "gelu")])
def test_cuda_gemm_matches_plain(cuda, m, k, n, act):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, w = _bf16((m, k), g, cuda), _bf16((k, n), g, cuda, k ** -0.5)
    b = _bf16((n,), g, cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = tgemm.gemm_cuda(x, w, b, scale=0.5, act=act,
                              out_dtype=out_dtype)
        want = ref.gemm_ref(x, w, bias=b, scale=0.5, act=act,
                            out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window,cap,D", [(64, 0, 0.0, 128),
                                            (215, 0, 0.0, 128),
                                            (100, 17, 5.0, 64)])
def test_cuda_flash_attention_matches_plain(cuda, S, window, cap, D):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = _bf16((16, S, D), g, cuda)
    k, v = _bf16((8, S, D), g, cuda), _bf16((8, S, D), g, cuda)
    for causal, kv_len in itertools.product((True, False), (0, S - 3)):
        kw = dict(causal=causal, window=window, cap=cap, kv_len=kv_len)
        torch.testing.assert_close(
            tfa.flash_attention_cuda(q, k, v, **kw).float(),
            ref.flash_attention_ref(q, k, v, **kw).float(),
            atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D,G,page", [(128, 2, 16), (64, 8, 8), (256, 1, 32)])
def test_cuda_paged_attention_matches_plain(cuda, D, G, page):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, K, N, P = 5, 4, 64, 12
    q = _bf16((B, K, G, D), g, cuda)
    kp, vp = _bf16((N, page, K, D), g, cuda), _bf16((N, page, K, D), g, cuda)
    lengths = torch.tensor([1, page + 1, 0, P * page, 3 * page],
                           dtype=torch.int32, device=cuda)
    tables = torch.randperm(N - 1, generator=g, device=cuda)[:B * P] + 1
    tables = tables.reshape(B, P).to(torch.int32).contiguous()
    for cap in (0.0, 4.0):
        torch.testing.assert_close(
            tpa.paged_attention_cuda(q, kp, vp, tables, lengths,
                                     cap=cap).float(),
            ref.paged_attention_ref(q, kp, vp, tables, lengths,
                                        cap=cap).float(),
            atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# quantized kernels: gemm_wq and paged_attention over int8 / fp8 pools
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,block,m,k,n,act", [
    ("int8", 32, 4, 1024, 3072, "silu"), ("fp8", 32, 64, 3072, 1024, None),
    ("int4", 32, 4, 1024, 3072, "gelu"), ("int8", 0, 37, 200, 65, None),
    ("int4", 16, 5, 96, 130, "silu")])
def test_cuda_gemm_wq_matches_plain(cuda, dtype, block, m, k, n, act):
    g = torch.Generator(device=cuda).manual_seed(3)
    x, w = _bf16((m, k), g, cuda), _bf16((k, n), g, cuda, k ** -0.5)
    qw, scales = quantize_weight(w, dtype, block=block)
    b = _bf16((n,), g, cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = twq.gemm_wq_cuda(x, qw, scales, b, scale=0.5, act=act,
                               out_dtype=out_dtype)
        want = ref.gemm_wq_ref(x, qw, scales, bias=b, scale=0.5, act=act,
                               out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    got = twq.gemm_wq_cuda(x.float(), qw, scales, act=act)
    torch.testing.assert_close(
        got, ref.gemm_wq_ref(x.float(), qw, scales, act=act), atol=2e-2,
        rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("D,G,page", [(128, 2, 16), (64, 8, 8)])
def test_cuda_paged_attention_quant_matches_plain(cuda, dtype, D, G, page):
    g = torch.Generator(device=cuda).manual_seed(4)
    B, K, N, P = 5, 4, 64, 12
    q = _bf16((B, K, G, D), g, cuda)
    (kp, ks), (vp, vs) = (quantize_kv(_bf16((N, page, K, D), g, cuda), dtype)
                          for _ in range(2))
    lengths = torch.tensor([1, page + 1, 0, P * page, 3 * page],
                           dtype=torch.int32, device=cuda)
    tables = torch.randperm(N - 1, generator=g, device=cuda)[:B * P] + 1
    tables = tables.reshape(B, P).to(torch.int32).contiguous()
    for cap in (0.0, 4.0):
        args = (q, kp, vp, tables, lengths, ks, vs)
        torch.testing.assert_close(
            tpa.paged_attention_cuda(*args, cap=cap).float(),
            ref.paged_attention_ref(*args, cap=cap).float(),
            atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# lru_scan: the extend_step chunk and the forward pass of falcon-mamba-7b
# (D = 8192 * 16), and a ragged shape
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("B,L,D", [(1, 64, 131072), (1, 215, 131072),
                                   (3, 37, 1000)])
def test_cuda_lru_scan_matches_plain(cuda, B, L, D):
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.rand((B, L, D), generator=g, device=cuda) * 0.5 + 0.5
    b = torch.randn((B, L, D), generator=g, device=cuda)
    torch.testing.assert_close(tlru.lru_scan_cuda(a, b),
                               ref.lru_scan_ref(a, b), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# packed_gather_rows: qwen2-moe-a2.7b's decode (T = 4 rows, M = 16) and
# prefill chunk (T = 64, M = 256) token streams, a ragged float32 shape with
# unsorted int64 indices, narrow and odd rows, clamped indices, and a table
# view whose base is not 16-byte aligned
# --------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("N,D,M,dtype,idx_dtype", [
    (4, 2048, 16, torch.bfloat16, torch.int64),
    (64, 2048, 256, torch.bfloat16, torch.int32),
    (1000, 100, 37, torch.float32, torch.int64),
    (50, 3, 1001, torch.float16, torch.int32)])
def test_cuda_packed_gather_matches_plain(cuda, N, D, M, dtype, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    table = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    idx = torch.randint(-N - 3, N + 3, (M,), generator=g, device=cuda)
    idx = idx.to(idx_dtype)
    assert torch.equal(tpg.packed_gather_rows_cuda(table, idx),
                       ref.gather_rows_ref(table, idx))
    # a view one row in: its base address is D * elt bytes past the
    # allocation's, so the copy unit narrows where D * elt is not a
    # multiple of 16
    view = torch.randn((N + 1, D), generator=g, device=cuda).to(dtype)[1:]
    assert torch.equal(tpg.packed_gather_rows_cuda(view, idx),
                       ref.gather_rows_ref(view, idx))
