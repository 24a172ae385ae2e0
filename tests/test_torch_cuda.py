"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The file imports no JAX, so it runs where only PyTorch is installed. Inputs
are bf16 from seeded ``torch.Generator``s, at the serving path's widths and
at ragged shapes; outputs are compared at atol/rtol 2e-2 (a little over one
bf16 rounding step of the outputs, whose magnitudes stay below ~2).
"""
from __future__ import annotations

import itertools

import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref


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
