"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold it against its JAX twin in ``repro.kernels.ref``
and against the Pallas kernel run in interpret mode through
``repro.kernels.ops`` (as ``tests/test_kernels.py`` runs it), on the same
inputs made with numpy from fixed seeds. They also hold the launch geometry,
block-table index math and tile/page skip predicates that the CUDA kernels
mirror. ``test_torch_cuda.py`` runs the CUDA kernels themselves.

Tolerances: float32 inputs agree to atol/rtol 1e-5 (only the summation
order differs); bf16 inputs give bf16 outputs, compared at atol/rtol 2e-2,
a little over one bf16 rounding step of values up to ~2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dispatch import use_backend
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models.cache import page_rows

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``
    (bf16 values are rounded once, in torch, and handed to both)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# --------------------------------------------------------------------------
# gemm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (37, 200, 65), (100, 96, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + n)
    x, jx = _pair(rng.standard_normal((m, k)) * 0.5, dtype)
    w, jw = _pair(rng.standard_normal((k, n)) * 0.5, dtype)
    got = ops.gemm(x, w)
    assert got.dtype == x.dtype and got.shape == (m, n)
    _close(got, jref.gemm_ref(jx, jw), dtype)
    with use_backend("interpret"):
        _close(got, jops.gemm(jx, jw), dtype)


@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_gemm_epilogue_matches_jax(act):
    rng = np.random.default_rng(7)
    x, jx = _pair(rng.standard_normal((21, 48)), "float32")
    w, jw = _pair(rng.standard_normal((48, 40)), "float32")
    b, jb = _pair(rng.standard_normal(40), "float32")
    got = ops.gemm(x, w, b, scale=0.125, act=act)
    _close(got, jref.gemm_ref(jx, jw, bias=jb, scale=0.125, act=act),
           "float32")
    with use_backend("interpret"):
        _close(got, jops.gemm(jx, jw, jb, scale=0.125, act=act), "float32")


@pytest.mark.parametrize("M,N", [(1, 1), (4, 3072), (64, 1024), (65, 63)])
def test_gemm_launch_geometry_covers_output_once(M, N):
    gx, gy = tgemm.launch_geometry(M, N)
    assert (gx - 1) * tgemm.BLOCK_N < N <= gx * tgemm.BLOCK_N
    assert (gy - 1) * tgemm.BLOCK_M < M <= gy * tgemm.BLOCK_M


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, 8, dtype=torch.bfloat16)
    before = [k.launches for k in ops.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tgemm.gemm_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(x[None], x[None], x[None])
    ops.gemm(x, w)
    assert [k.launches for k in ops.KERNELS] == before


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 8, 0.0), (True, 0, 5.0), (False, 0, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(causal, window, cap, dtype):
    rng = np.random.default_rng(3)
    BH, BK, S, D = 4, 2, 37, 16
    q, jq = _pair(rng.standard_normal((BH, S, D)), dtype)
    k, jk = _pair(rng.standard_normal((BK, S, D)), dtype)
    v, jv = _pair(rng.standard_normal((BK, S, D)), dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == (BH, S, D)
    _close(got, jref.flash_attention_ref(jq, jk, jv, **kw), dtype)
    with use_backend("interpret"):
        _close(got, jops.flash_attention(jq, jk, jv, **kw), dtype)


def test_flash_attention_kv_len_masks_padded_keys():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32))
    got = ops.flash_attention(q, k, v, causal=False, kv_len=13)
    want = ops.flash_attention(q, k[:, :13].contiguous(),
                               v[:, :13].contiguous(), causal=False)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 37, 100, 130])
@pytest.mark.parametrize("window", [0, 1, 5, 70])
@pytest.mark.parametrize("causal", [True, False])
def test_kv_tile_range_is_exactly_the_live_tiles(S, window, causal):
    """The KV tiles a query tile walks are exactly the tiles holding a key
    one of its rows may see: every skipped tile is fully masked."""
    for kv_len in sorted({S, S // 2 + 1}):
        qpos = np.arange(S)[:, None]
        kpos = np.arange(S)[None, :]
        mask = np.broadcast_to(kpos < kv_len, (S, S))
        if causal:
            mask = mask & (qpos >= kpos)
        if window:
            mask = mask & (qpos - kpos < window)
        for q0 in range(0, S, tfa.BLOCK_Q):
            rows = mask[q0:q0 + tfa.BLOCK_Q]
            live = {t for t in range(-(-S // tfa.BLOCK_KV))
                    if rows[:, t * tfa.BLOCK_KV:(t + 1) * tfa.BLOCK_KV].any()}
            lo, hi = tfa.kv_tile_range(q0, S, S, causal=causal,
                                       window=window, kv_len=kv_len)
            assert set(range(lo, hi)) == live, (q0, kv_len)


def test_flash_launch_geometry():
    assert tfa.launch_geometry(16, 1) == (16, 1)
    assert tfa.launch_geometry(16, 215) == (16, 7)
    assert tfa.launch_geometry(3, 64) == (3, 2)


# --------------------------------------------------------------------------
# paged_attention
# --------------------------------------------------------------------------
def _paged_inputs(dtype, rng):
    B, K, G, D, page, N, P = 4, 2, 2, 16, 8, 14, 4
    q, jq = _pair(rng.standard_normal((B, K, G, D)), dtype)
    kp, jkp = _pair(rng.standard_normal((N, page, K, D)), dtype)
    vp, jvp = _pair(rng.standard_normal((N, page, K, D)), dtype)
    tables = np.zeros((B, P), np.int32)
    blocks = rng.permutation(np.arange(1, N))
    lengths = np.array([9, 32, 1, 0], np.int32)   # page-crossing, full, one
    for b, n in enumerate(lengths):              # row, and an empty slot
        tables[b, :-(-n // page)] = blocks[b * P:b * P + -(-n // page)]
    return (q, kp, vp, torch.from_numpy(tables), torch.from_numpy(lengths),
            (jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(lengths)))


@pytest.mark.parametrize("cap", [0.0, 4.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_plain_matches_jax(dtype, cap):
    *args, jargs = _paged_inputs(dtype, np.random.default_rng(5))
    got = ops.paged_attention(*args, cap=cap)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    live = np.asarray(args[4]) > 0
    # repro's gather oracle averages the null block on an empty slot; the
    # kernels (Pallas and CUDA) and the port's plain version return zeros
    want = np.asarray(jref.paged_attention_ref(*jargs, cap=cap), np.float32)
    _close(got[live], want[live], dtype)
    assert not got[~live].any()
    with use_backend("interpret"):
        _close(got, jops.paged_attention(*jargs, cap=cap), dtype)


def test_pages_to_read_is_the_page_skip_predicate():
    for page in (1, 8, 16):
        for length in range(0, 50):
            assert tpa.pages_to_read(length, page) == sum(
                j * page < length for j in range(50))


def test_page_rows_block_table_index_math():
    rng = np.random.default_rng(6)
    tables = rng.integers(1, 40, (3, 5)).astype(np.int32)
    pos = np.array([0, 17, 39])
    blk, row = page_rows(torch.from_numpy(tables), torch.from_numpy(pos), 8)
    assert blk.tolist() == [tables[b, p // 8] for b, p in enumerate(pos)]
    assert row.tolist() == [p % 8 for p in pos]
    one = torch.from_numpy(tables[1])
    blk, row = page_rows(one, torch.arange(40), 8)
    assert blk.tolist() == [tables[1, p // 8] for p in range(40)]
    assert row.tolist() == [p % 8 for p in range(40)]


def test_paged_launch_geometry_and_shared_memory():
    grid, smem = tpa.launch_geometry(B=4, K=8, G=2, D=128, page=16)
    assert grid == (4, 8) and smem == 4 * 2 * (128 + 16)
    _, smem = tpa.launch_geometry(B=1, K=1, G=tpa.G_MAX, D=256, page=1024)
    assert smem <= tpa.SMEM_LIMIT
