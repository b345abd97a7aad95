"""The port's kernels, configs and guards against the JAX reference.

Each plain PyTorch version in ``repro_torch.kernels.ref`` (what the
wrappers run for CPU tensors) is held against the Pallas kernel in
interpret mode and against ``repro.kernels.ref``, on the same numpy inputs.
Tolerances are the repo's: fp32 2e-5; bf16 rtol 3e-2, atol 2e-2 (the
operands round at 8 mantissa bits, sums are taken in fp32 in another
order).  The ``gpu`` tests hold each CUDA kernel against its plain version
on the card and skip where there is none.
"""

import ast
import dataclasses
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import blocks as tblocks  # noqa: E402
from repro_torch.serve import scheduler as tscheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def J():
    """The JAX reference's modules.  Imported in a fixture, so the ``gpu``
    tests also run where only the port is installed."""
    pytest.importorskip("jax")
    import repro  # noqa: F401  (installs the JAX compat shims)
    import jax.numpy as jnp
    from repro.configs import base
    from repro.kernels import flash_attention, gemm, paged_attention
    from repro.kernels import ref as jref
    from repro.models import layers
    from repro.serve import blocks, scheduler
    return SimpleNamespace(
        jnp=jnp, base=base, fa=flash_attention, gemm=gemm,
        paged=paged_attention, ref=jref, layers=layers, blocks=blocks,
        scheduler=scheduler,
        dt={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(J, x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, on the JAX side, and carried bit for bit)."""
    j = J.jnp.asarray(x).astype(J.dt[dtype])
    if dtype == "bfloat16":
        bits = np.asarray(j).view(np.uint16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _close(got, want, dtype, mask=None):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, **TOL[dtype])


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (128, 256, 256)])
def test_matmul_plain_matches_pallas_interpret(J, m, k, n, dtype):
    ja, ta = _pair(J, _normal(0, (m, k)), dtype)
    jb, tb = _pair(J, _normal(1, (k, n)), dtype)
    want = J.gemm.matmul(ja, jb, bm=64, bn=128, bk=128, interpret=True)
    _close(ops.matmul(ta, tb), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 96, 40), (5, 13, 7), (130, 70, 33)])
def test_matmul_plain_matches_reference_on_ragged_shapes(J, m, k, n, dtype):
    ja, ta = _pair(J, _normal(2, (m, k)), dtype)
    jb, tb = _pair(J, _normal(3, (k, n)), dtype)
    for out in ("float32", dtype):
        got = ops.matmul(ta, tb, out_dtype=TDT[out])
        assert got.dtype == TDT[out] and got.shape == (m, n)
        _close(got, J.ref.matmul(ja, jb, out_dtype=J.dt[out]), dtype)


@pytest.mark.parametrize("f32,a_t", [(False, False), (False, True),
                                       (True, False)])
def test_gemm_plan_groups_follow_k_and_splits_hold_whole_groups(f32, a_t):
    """The kernel's plan: the K groups depend on K alone (so no M, tile or
    split changes the order of the adds), at most 32 of them, each a
    multiple of 256 deep; a split gives every block exactly one group;
    the regime follows M and the layout."""
    from repro_torch.kernels import gemm
    ms = (1, 8, 44, 64, 65, 128, 300, 1024)
    ns = (7, 48, 128, 896, 4864, 151_936)
    for k in (1, 13, 255, 256, 257, 896, 1536, 3072, 4864, 8192, 8193,
              151_936):
        pls = [gemm.plan(m, k, n, f32=f32, a_transposed=a_t)
               for m in ms for n in ns]
        assert {(pl.kg, pl.groups) for pl in pls} == {
            (gemm.group_depth(k), -(-k // gemm.group_depth(k)))}
        pl = pls[0]
        assert pl.kg % 256 == 0 and 1 <= pl.groups <= 32
        assert (pl.groups - 1) * pl.kg < k <= pl.groups * pl.kg
        assert pl.kg == 256 or -(-k // (pl.kg - 256)) > 32
        for m, pl in zip([m for m in ms for _ in ns], pls):
            assert pl.split in (1, pl.groups)
            want = ("fp32" if f32 else "wide" if m > 64 or a_t
                    else "skinny")
            assert pl.regime == want
            assert pl.tile_m in {"fp32": (64,), "wide": (64, 128),
                                 "skinny": (8, 16, 32, 64)}[pl.regime]
            assert pl.regime != "skinny" or pl.tile_m >= m
    # qwen2-0.5b's decode products fill the card by splitting K
    out = gemm.plan(8, 4864, 896)
    assert (out.regime, out.tile_m, out.split) == ("skinny", 8, 19)
    assert gemm.plan(8, 896, 151_936).split == 1


@pytest.mark.parametrize("m,k,n", [
    (8, 896, 896), (8, 896, 128), (8, 896, 4864), (8, 4864, 896),
    (8, 896, 151936),                                  # qwen2-0.5b decode
    (128, 896, 896), (128, 896, 4864), (128, 4864, 896),   # prefill chunk
    (8, 1024, 1024), (5, 300, 77), (130, 257, 129), (1, 20000, 64)])
@pytest.mark.parametrize("f32", [False, True])
def test_dequant_plan_is_the_matmul_plan(m, k, n, f32):
    """``matmul_dequant`` launches under ``plan_of(a, b_q)``: the plan of
    ``gemm.plan`` for the same (M, K, N, f32), which ``matmul`` takes on
    the weights widened to the activations' type; the bitwise pin on the
    card rests on it."""
    from repro_torch.kernels import gemm
    dt = torch.float32 if f32 else torch.bfloat16
    a = torch.empty((m, k), dtype=dt, device="meta")
    bq = torch.empty((k, n), dtype=torch.int8, device="meta")
    pl = gemm.plan_of(a, bq)
    assert pl == gemm.plan(m, k, n, f32=f32)
    assert pl == gemm.plan_of(a, bq.to(dt))
    assert pl.regime == ("fp32" if f32 else "skinny" if m <= 64 else "wide")


def test_gemm_wrapper_reads_layouts_and_tma_alignment():
    from repro_torch.kernels import gemm
    x = torch.zeros(6, 16, dtype=torch.bfloat16)
    assert gemm._layout(x, "A") == 0 and gemm._layout(x.t(), "A") == 1
    with pytest.raises(ValueError):
        gemm._layout(x[:, ::2], "A")
    assert gemm.uses_tma(x, x.t())          # stored rows of 32 bytes
    y = torch.zeros(6, 13, dtype=torch.bfloat16)    # 26 bytes a row
    assert not gemm.uses_tma(y, x)
    assert not gemm.uses_tma(x, y.t())
    assert gemm.uses_tma(y.float()[:, :12].contiguous(), x)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (Hq, Hkv, S, T, q_offset, window, softcap)
    (14, 2, 32, 64, 32, None, None),      # qwen2's GQA group, chunk offset
    (4, 4, 32, 32, 0, None, None),
    (4, 1, 16, 64, 48, 24, None),         # sliding window
    (4, 2, 32, 32, 0, None, 5.0),         # softcap
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,t,off,window,softcap", ATTN_CASES)
def test_attention_plain_matches_pallas_and_reference(
        J, hq, hkv, s, t, off, window, softcap, dtype):
    jq, tq = _pair(J, _normal(4, (2, hq, s, 16)), dtype)
    jk, tk = _pair(J, _normal(5, (2, hkv, t, 16)), dtype)
    jv, tv = _pair(J, _normal(6, (2, hkv, t, 16)), dtype)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    got = ops.attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    # compare only rows with a visible key (the Pallas kernel gives
    # mean(V) on the others and the reference oracle NaN)
    qpos = np.arange(s) + off
    first = np.zeros_like(qpos) if window is None else qpos - window + 1
    visible = np.minimum(qpos, t - 1) >= np.maximum(first, 0)
    mask = np.broadcast_to(visible[None, None, :, None], got.shape)
    _close(got, J.fa.attention(jq, jk, jv, bq=16, bkv=16, interpret=True,
                              **kw), dtype, mask)
    _close(got, J.ref.attention(jq, jk, jv, **kw), dtype, mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,off,window,softcap", [
    (16, 32, 16, None, None), (16, 48, 32, 12, None), (24, 32, 8, None, 5.0)])
def test_attention_plain_at_head_dim_256_matches_pallas(J, s, t, off, window,
                                                        softcap, dtype):
    """gemma-2b's head dim and MQA (8 query heads on one kv head), which
    the CUDA kernels take too: the plain version against the Pallas
    kernel in interpret mode."""
    jq, tq = _pair(J, _normal(14, (1, 8, s, 256)), dtype)
    jk, tk = _pair(J, _normal(15, (1, 1, t, 256)), dtype)
    jv, tv = _pair(J, _normal(16, (1, 1, t, 256)), dtype)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    got = ops.attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    _close(got, J.fa.attention(jq, jk, jv, bq=8, bkv=16, interpret=True,
                              **kw), dtype)


def test_attention_rows_without_visible_keys_are_zero(J):
    """The port follows the model's attention (``flash_attention_jnp``):
    a fully-masked row is zero."""
    jq, tq = _pair(J, _normal(7, (1, 2, 8, 16)), "float32")
    jk, tk = _pair(J, _normal(8, (1, 2, 32, 16)), "float32")
    jv, tv = _pair(J, _normal(9, (1, 2, 32, 16)), "float32")
    kw = dict(causal=True, window=1, q_offset=20)      # window=1, T=32:
    got = ops.attention(tq, tk, tv, **kw)              # rows 12.. see none
    want = J.layers.flash_attention_jnp(jq, jk, jv, bq=8, bkv=8, **kw)
    _close(got, want, "float32")
    assert (got[:, :, 12:] == 0).all() and (got[:, :, :12] != 0).any()


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------

def _paged_case(seed, B, Hq, Hkv, hd, page, nb):
    """(q, k_pages, v_pages) as fp32 numpy, a permuted int32 table that
    leaves the NULL page 0 out, and ragged int32 lengths >= 1."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    q = _normal(seed, (B, Hq, hd))
    kp = _normal(seed + 1, (P, page, Hkv, hd))
    vp = _normal(seed + 2, (P, page, Hkv, hd))
    tbl = (rng.permutation(P - 1) + 1).reshape(B, nb).astype(np.int32)
    lens = rng.integers(1, nb * page + 1, size=B).astype(np.int32)
    lens[0] = 1                                   # the contract's edge
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(14, 2), (4, 4), (6, 2)])
def test_paged_plain_matches_pallas_and_reference(J, hq, hkv, dtype):
    q, kp, vp, tbl, lens = _paged_case(11, 3, hq, hkv, 16, 8, 4)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(J, x, dtype) for x in (q, kp, vp))
    j = (jq, jk, jv, J.jnp.asarray(tbl), J.jnp.asarray(lens))
    t = (tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(lens))
    got = ops.paged_decode_attention(*t)
    assert got.dtype == TDT[dtype] and got.shape == t[0].shape
    _close(got, J.paged.paged_decode_attention(*j, interpret=True), dtype)
    _close(got, J.ref.paged_decode_attention(*j), dtype)


def _split_lens(split, nb, page):
    """Lengths at the edges of the kernel's splits: 1, split - 1, split,
    split + 1 and the full table (the splits past each shorter length
    are wholly masked)."""
    return np.array([1, split - 1, split, split + 1, nb * page], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hq,hkv", [(16, 14, 2), (256, 4, 2)])
def test_paged_split_combine_matches_pallas_and_reference(J, hd, hq, hkv,
                                                          dtype):
    """The kernel's order of work (splits of 16 keys here, pages of 8)
    against the gather-then-attend plain version, the Pallas kernel in
    interpret mode and the reference oracle, at lengths around the split
    and with splits wholly past the length (no NaN)."""
    split, page, nb = 16, 8, 6
    lens = _split_lens(split, nb, page)
    q, kp, vp, tbl, _ = _paged_case(13, len(lens), hq, hkv, hd, page, nb)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(J, x, dtype) for x in (q, kp, vp))
    j = (jq, jk, jv, J.jnp.asarray(tbl), J.jnp.asarray(lens))
    t = (tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(lens))
    got = ref.paged_decode_split_combine(*t, split=split)
    assert got.dtype == TDT[dtype] and got.shape == t[0].shape
    assert torch.isfinite(got.float()).all()
    _close(got, ref.paged_decode_attention(*t).float(), dtype)
    _close(got, J.paged.paged_decode_attention(*j, interpret=True), dtype)
    _close(got, J.ref.paged_decode_attention(*j), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_at_head_dim_256_matches_pallas(J, dtype):
    """gemma-2b's head dim, which the reference kernel takes."""
    q, kp, vp, tbl, lens = _paged_case(17, 3, 8, 1, 256, 16, 3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(J, x, dtype) for x in (q, kp, vp))
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(tbl),
                                     torch.from_numpy(lens))
    _close(got, J.paged.paged_decode_attention(
        jq, jk, jv, J.jnp.asarray(tbl), J.jnp.asarray(lens),
        interpret=True), dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(seed, shape, dev, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16).to(dev)


# qwen2-0.5b's products at decode (M = 8), prefill (M = 128) and train
# (M = 1,024), mamba2-780m's wdt (N = 48) and w_out (K = 3,072) at decode
# and a ragged prefill (M = 300), and ragged shapes (the element-load
# producer: a stored row not a multiple of 8 elements)
GEMM_SHAPES = [(8, 896, 4864), (8, 896, 128), (8, 4864, 896),
               (128, 4864, 896), (128, 896, 896), (1024, 896, 4864),
               (1024, 4864, 896), (8, 1536, 48), (300, 1536, 48),
               (8, 3072, 1536), (300, 3072, 1536), (5, 13, 7), (70, 130, 66)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(cuda, m, k, n):
    """bf16 operands at the repo's bf16 tolerance; fp32 operands at the
    reference kernel test's fp32 tolerance (rtol 1e-5, atol 1e-2:
    ``tests/test_kernels.py``) on unit-variance operands that are not
    bf16 values, as that test draws them.  The kernel's CUDA-core FMAs
    keep it; ``torch.matmul`` with TF32 allowed, a control, must not
    where K is a model's (its error grows as ~4e-4 sqrt(K)) and M and N
    are wide enough that cuBLAS takes its tensor cores."""
    a, b = _bf16(0, (m, k), cuda), _bf16(1, (k, n), cuda, 0.05)
    for out in (torch.float32, torch.bfloat16):
        got = ops.matmul(a, b, out_dtype=out)
        assert got.dtype == out and got.shape == (m, n)
        torch.testing.assert_close(got.float(), ref.matmul(a, b, out).float(),
                                   rtol=3e-2, atol=2e-2)
    g = torch.Generator().manual_seed(2)
    a32 = torch.randn((m, k), generator=g).to(cuda)
    b32 = torch.randn((k, n), generator=g).to(cuda)
    want = ref.matmul(a32, b32)
    got = ops.matmul(a32, b32)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-2)
    if k >= 896 and m >= 128 and n >= 128:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = torch.matmul(a32, b32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        with pytest.raises(AssertionError):
            torch.testing.assert_close(control, want, rtol=1e-5, atol=1e-2)
    mixed = ops.matmul(a, b32, torch.float32)    # promoted: fp32 @ fp32
    torch.testing.assert_close(mixed, ref.matmul(a.float(), b32),
                               rtol=1e-5, atol=1e-2)


# (K, N) of qwen2-0.5b's and mamba2-780m's products and the ragged cases
INVARIANT_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                (1536, 48), (3072, 1536), (13, 7), (130, 66)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,n", INVARIANT_KN)
def test_gemm_rows_are_invariant_bitwise(cuda, k, n, dtype):
    """Row i of C depends on A[i], B, K and N only: rows taken from a
    1,024-row product equal the product of those rows alone, for every M
    the regimes and splits cut differently."""
    dt = TDT[dtype]
    a = _bf16(30, (1024, k), cuda).to(dt)
    b = _bf16(31, (k, n), cuda, 0.05).to(dt)
    full = ops.matmul(a, b, torch.float32)
    for m in (1, 8, 44, 64, 65, 128, 300, 1024):
        rows = torch.randperm(1024, generator=torch.Generator().manual_seed(m)
                              )[:m].to(cuda)
        part = ops.matmul(a[rows].contiguous(), b, torch.float32)
        assert torch.equal(part, full[rows]), (m, k, n)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 4864, 896), (1024, 896, 4864),
                                   (300, 1536, 48), (70, 130, 66)])
def test_gemm_runs_give_the_same_bits(cuda, m, k, n):
    a, b = _bf16(40, (m, k), cuda), _bf16(41, (k, n), cuda, 0.05)
    for dt in (torch.bfloat16, torch.float32):
        first = ops.matmul(a.to(dt), b.to(dt), torch.float32)
        for _ in range(3):
            assert torch.equal(ops.matmul(a.to(dt), b.to(dt), torch.float32),
                               first)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1024, 896, 896), (1024, 896, 151_936),
                                   (1024, 4864, 896), (8, 896, 128),
                                   (70, 130, 66)])
def test_gemm_transposed_operands_are_bitwise_the_copies(cuda, m, k, n):
    """A stored (K, M) and B stored (N, K), as the backward passes them,
    give the bits of the same product on contiguous copies, in bf16 and
    fp32: the backward's dA = dC·Bᵀ and dB = Aᵀ·dC at train shapes."""
    from repro_torch.kernels import gemm
    for dt in (torch.bfloat16, torch.float32):
        a = _bf16(50, (m, k), cuda).to(dt)
        b = _bf16(51, (k, n), cuda, 0.05).to(dt)
        dc = _bf16(52, (m, n), cuda).to(dt)
        for x, y in ((dc, b.t()), (a.t(), dc), (a.t().contiguous().t(), b),
                     (a, b.t().contiguous().t())):
            assert gemm._layout(x, "A") + gemm._layout(y, "B") >= 0
            got = ops.matmul(x, y, torch.float32)
            want = ops.matmul(x.contiguous(), y.contiguous(), torch.float32)
            assert torch.equal(got, want), (m, k, n, dt, x.stride(),
                                            y.stride())


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,off,window,softcap", [
    (128, 512, 384, None, None), (37, 100, 50, None, None),
    (64, 128, 64, 16, 5.0)])
def test_flash_kernel_matches_plain(cuda, s, t, off, window, softcap):
    q = _bf16(2, (1, 14, s, 64), cuda)
    k, v = _bf16(3, (1, 2, t, 64), cuda), _bf16(4, (1, 2, t, 64), cuda)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    torch.testing.assert_close(ops.attention(q, k, v, **kw).float(),
                               ref.attention(q, k, v, **kw).float(),
                               rtol=3e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("s,t,off,window,softcap", [
    (128, 512, 384, None, None), (37, 100, 50, 24, 5.0)])
def test_flash_head_dims_match_plain(cuda, d, s, t, off, window, softcap):
    """The kernel's other head dims (32: rows padded to 64 in shared
    memory; 128: two 64-wide boxes; 256: four, P·V as two 128-wide
    products and dK/dV in two column halves), forward and backward, at
    the bf16 tolerances."""
    q = _bf16(5, (2, 4, s, d), cuda)
    k, v = _bf16(6, (2, 2, t, d), cuda), _bf16(7, (2, 2, t, d), cuda)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    torch.testing.assert_close(ops.attention(q, k, v, **kw).float(),
                               ref.attention(q, k, v, **kw).float(),
                               rtol=3e-2, atol=2e-2)
    d_out = _bf16(8, (2, 4, s, d), cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(ops.attention(*leaves, **kw), leaves, d_out)
    _grads_close(got, ref.attention_backward(q, k, v, d_out, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,off,window,softcap", [
    (128, 512, 384, None, None), (37, 100, 50, None, None),
    (64, 128, 64, 16, 5.0)])
def test_flash_fp32_kernel_matches_plain(cuda, s, t, off, window, softcap):
    """fp32 q, k, v take the CUDA-core kernel, held at the reference
    kernel test's fp32 tolerance (rtol 2e-5, ``tests/test_kernels.py``)
    with atol 2e-2; the backward refuses them."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((1, 14, s, 64), generator=g).to(cuda)
    k = torch.randn((1, 2, t, 64), generator=g).to(cuda)
    v = torch.randn((1, 2, t, 64), generator=g).to(cuda)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    got = ops.attention(q, k, v, **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.attention(q, k, v, **kw),
                               rtol=2e-5, atol=2e-2)
    with pytest.raises(TypeError, match="bf16"):
        ops.attention(q.requires_grad_(True), k, v, **kw)


def _chunked_like_paged_prefill(q, k, v, chunk=128, page=64, **kw):
    """(out, lse) of q (1,H,S,D)'s rows computed chunk by chunk as
    ``attention.prefill_chunk_paged`` calls the kernel: ``chunk`` query
    rows (the last end-padded) at ``q_offset = start`` against the keys of
    the live pages (a multiple of ``page``; keys past S hold other
    values)."""
    from repro_torch.kernels import flash_attention as fa
    S, D = q.shape[2], q.shape[3]
    g = torch.Generator(device=q.device).manual_seed(99)
    outs, lses = [], []
    for start in range(0, S, chunk):
        n, T = min(chunk, S - start), -(-(start + chunk) // page) * page
        qc = torch.randn(q.shape[:2] + (chunk, D), generator=g,
                         device=q.device).to(q.dtype)
        kc, vc = (torch.randn(x.shape[:2] + (T, D), generator=g,
                              device=q.device).to(q.dtype) for x in (k, v))
        qc[:, :, :n] = q[:, :, start:start + n]
        kc[:, :, :min(T, S)] = k[:, :, :T]
        vc[:, :, :min(T, S)] = v[:, :, :T]
        out, lse = fa._forward(qc, kc, vc, True, kw.get("window"),
                               kw.get("softcap"), D ** -0.5, start,
                               with_lse=True)
        outs.append(out[:, :, :n])
        lses.append(lse[:, :, :n])
    return torch.cat(outs, 2), torch.cat(lses, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, None), (100, None),
                                            (None, 30.0), (100, 30.0)])
def test_flash_rows_are_invariant_bitwise(cuda, window, softcap):
    """A 300-token prompt at qwen2's heads in one call (S = T = 300) and
    chunk by chunk as the paged prefill runs it give each row the same
    output and log-sum-exp bits."""
    from repro_torch.kernels import flash_attention as fa
    q = _bf16(60, (1, 14, 300, 64), cuda)
    k, v = _bf16(61, (1, 2, 300, 64), cuda), _bf16(62, (1, 2, 300, 64), cuda)
    out, lse = fa._forward(q, k, v, True, window, softcap, 64 ** -0.5, 0,
                           with_lse=True)
    c_out, c_lse = _chunked_like_paged_prefill(q, k, v, window=window,
                                               softcap=softcap)
    assert torch.equal(c_out, out) and torch.equal(c_lse, lse)


@pytest.mark.gpu
def test_flash_runs_give_the_same_bits(cuda):
    """The forward (with its log-sum-exp) and the backward at the train
    shape, run again on the same inputs, give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    q, d_out = _bf16(70, (2, 14, 512, 64), cuda), _bf16(71, (2, 14, 512, 64),
                                                        cuda)
    k, v = _bf16(72, (2, 2, 512, 64), cuda), _bf16(73, (2, 2, 512, 64), cuda)
    args = (True, None, None, 64 ** -0.5, 0)
    out, lse = fa._forward(q, k, v, *args, with_lse=True)
    grads = fa.attention_backward(q, k, v, out, d_out, lse)
    for _ in range(2):
        again = fa._forward(q, k, v, *args, with_lse=True)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
        assert all(torch.equal(a, b) for a, b in zip(
            fa.attention_backward(q, k, v, out, d_out, lse), grads))


@pytest.mark.gpu
def test_flash_head_dim_256_fp32_rows_and_runs(cuda):
    """gemma-2b's shapes at D = 256 (MQA, 8 query heads): the fp32 kernel
    at its tolerance, a 300-token prompt in one call and chunk by chunk
    bitwise (out and log-sum-exp), and the forward and backward at the
    train shape run to run bitwise."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(80)
    q32 = torch.randn((1, 8, 100, 256), generator=g).to(cuda)
    k32, v32 = (torch.randn((1, 1, 150, 256), generator=g).to(cuda)
                for _ in range(2))
    kw = dict(causal=True, window=64, softcap=None, q_offset=50)
    torch.testing.assert_close(ops.attention(q32, k32, v32, **kw),
                               ref.attention(q32, k32, v32, **kw),
                               rtol=2e-5, atol=2e-2)
    q = _bf16(81, (1, 8, 300, 256), cuda)
    k, v = _bf16(82, (1, 1, 300, 256), cuda), _bf16(83, (1, 1, 300, 256),
                                                    cuda)
    out, lse = fa._forward(q, k, v, True, None, None, 256 ** -0.5, 0,
                           with_lse=True)
    c_out, c_lse = _chunked_like_paged_prefill(q, k, v)
    assert torch.equal(c_out, out) and torch.equal(c_lse, lse)
    q, d_out = _bf16(84, (2, 8, 512, 256), cuda), _bf16(85, (2, 8, 512, 256),
                                                        cuda)
    k, v = _bf16(86, (2, 1, 512, 256), cuda), _bf16(87, (2, 1, 512, 256),
                                                    cuda)
    args = (True, None, None, 256 ** -0.5, 0)
    out, lse = fa._forward(q, k, v, *args, with_lse=True)
    grads = fa.attention_backward(q, k, v, out, d_out, lse)
    again = fa._forward(q, k, v, *args, with_lse=True)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.attention_backward(q, k, v, out, d_out, lse), grads))


@pytest.mark.gpu
def test_paged_kernel_matches_plain(cuda):
    q, kp, vp, tbl, lens = _paged_case(5, 8, 14, 2, 64, 64, 4)
    t = [torch.from_numpy(x).to(torch.bfloat16).to(cuda)
         for x in (q, kp, vp)]
    t += [torch.from_numpy(x).to(cuda) for x in (tbl, lens)]
    torch.testing.assert_close(ops.paged_decode_attention(*t).float(),
                               ref.paged_decode_attention(*t).float(),
                               rtol=3e-2, atol=2e-2)


def _paged_cuda(case, dev):
    q, kp, vp, tbl, lens = case
    return ([torch.from_numpy(x).to(torch.bfloat16).to(dev)
             for x in (q, kp, vp)]
            + [torch.from_numpy(x).to(dev) for x in (tbl, lens)])


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 7, 16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_paged_kernel_head_dims_and_lengths_match_plain(cuda, hd, g):
    """Every head dim the kernel takes, at 1, 7 and 16 query heads per kv
    head, at lengths 1, KS - 1, KS, KS + 1 and the full table (KS the
    kernel's split)."""
    from repro_torch.kernels import paged_attention as pa
    page, nb = 64, 6
    lens = _split_lens(pa.SPLIT, nb, page)
    q, kp, vp, tbl, _ = _paged_case(19, len(lens), 2 * g, 2, hd, page, nb)
    t = _paged_cuda((q, kp, vp, tbl, lens), cuda)
    before = pa.launches
    got = ops.paged_decode_attention(*t)
    assert pa.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(),
                               ref.paged_decode_attention(*t).float(),
                               rtol=3e-2, atol=2e-2)


@pytest.mark.gpu
def test_paged_kernel_bits_follow_the_sequence_alone(cuda):
    """A sequence's output bits depend on its q, K/V and length only: the
    same alone as inside a batch of 8 with other lengths, under a
    permuted page table holding the same logical K/V, and run to run."""
    q, kp, vp, tbl, lens = _paged_case(23, 8, 14, 2, 64, 64, 16)
    t = _paged_cuda((q, kp, vp, tbl, lens), cuda)
    out = ops.paged_decode_attention(*t)
    assert torch.equal(ops.paged_decode_attention(*t), out)
    for b in (0, 3, 7):
        alone = ops.paged_decode_attention(
            t[0][b:b + 1], t[1], t[2], t[3][b:b + 1].contiguous(),
            t[4][b:b + 1].contiguous())
        assert torch.equal(alone[0], out[b]), b
    perm = np.random.default_rng(29).permutation(kp.shape[0])
    moved = _paged_cuda((q, kp[np.argsort(perm)], vp[np.argsort(perm)],
                         perm[tbl].astype(np.int32), lens), cuda)
    assert torch.equal(ops.paged_decode_attention(*moved), out)


@pytest.mark.gpu
def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    t = _paged_cuda(_paged_case(31, 2, 4, 2, 64, 16, 2), cuda)
    with pytest.raises(ValueError):              # head dim 264 (> 256)
        ops.paged_decode_attention(
            *(torch.cat([x] * 5, -1)[..., :264].contiguous()
              for x in t[:3]), *t[3:])
    wide = _paged_cuda(_paged_case(31, 2, 17, 1, 64, 16, 2), cuda)
    with pytest.raises(ValueError):              # 17 query heads a kv head
        ops.paged_decode_attention(*wide)
    with pytest.raises(TypeError):               # fp32 q
        ops.paged_decode_attention(t[0].float(), *t[1:])
    with pytest.raises(TypeError):               # int64 table
        ops.paged_decode_attention(*t[:3], t[3].long(), t[4])
    with pytest.raises(ValueError):              # a strided q
        ops.paged_decode_attention(t[0].transpose(0, 1).contiguous()
                                   .transpose(0, 1), *t[1:])
    with pytest.raises(ValueError):              # q on the CPU
        ops.paged_decode_attention(t[0].cpu(), *t[1:])
    for i in range(3):                           # a view 2 bytes in
        flat = torch.empty(t[i].numel() + 1, dtype=t[i].dtype, device=cuda)
        moved = list(t)
        moved[i] = flat[1:].view(t[i].shape).copy_(t[i])
        assert moved[i].is_contiguous() and moved[i].data_ptr() % 16
        with pytest.raises(ValueError):
            ops.paged_decode_attention(*moved)


def ssd_case(seed, B, S, H, P, G, N, dtype, device="cpu", init=False):
    """SSD inputs as the model draws them: A = -U[1, 16] and dt in
    [1e-3, 0.1] log-uniform (the ``ssm_a`` and ``dt_bias`` inits), x, B, C
    standard normal in ``dtype``; an fp32 initial state when ``init``."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(size=(B, S, H)) * (np.log(0.1) - np.log(1e-3))
                + np.log(1e-3))
    arrs = dict(x=rng.standard_normal((B, S, H, P)), dt=dt,
                A=-rng.uniform(1.0, 16.0, H),
                Bm=rng.standard_normal((B, S, G, N)),
                C=rng.standard_normal((B, S, G, N)))
    if init:
        arrs["init_state"] = rng.standard_normal((B, H, P, N))
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device)
           for k, v in arrs.items()}
    for k in ("x", "Bm", "C"):
        out[k] = out[k].to(TDT[dtype])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N,init", [
    (1, 512, 48, 64, 1, 128, False),     # mamba2-780m's prefill shapes
    (1, 300, 48, 64, 1, 128, True),      # ragged tail, initial state
    (2, 200, 4, 32, 2, 16, True),        # two groups
    (2, 37, 6, 20, 3, 24, False),        # P not a multiple of the slice
])
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, G, N, init, dtype):
    """Tolerances of the reference's SSD kernel test: 2e-4 in fp32 (the
    same fp32 math chunked at 64 against 256), 5e-2 in bf16 (y is stored
    in bf16)."""
    from repro_torch.kernels import ssd_scan
    case = ssd_case(7, B, S, H, P, G, N, dtype, cuda, init)
    before = ssd_scan.launches
    y, state = ops.ssd(**case, chunk=256)
    assert ssd_scan.launches == before + 1
    y_want, s_want = ssd_scan.ssd_plain(**case, chunk=256)
    tol = 5e-2 if dtype == "bfloat16" else 2e-4
    assert y.dtype == TDT[dtype] and state.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, s_want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,init", [(1, False), (1, True), (64, False),
                                    (64, True)])
def test_ssd_kernel_one_step_and_one_chunk_match_plain(cuda, S, init, dtype):
    """S = 1 (a one-token prompt) and S = 64 (exactly the kernel's chunk)
    at mamba2-780m's widths, at the reference SSD test's tolerances."""
    case = ssd_case(11, 1, S, 48, 64, 1, 128, dtype, cuda, init)
    from repro_torch.kernels import ssd_scan
    y, state = ops.ssd(**case)
    y_want, s_want = ssd_scan.ssd_plain(**case, chunk=256)
    tol = 5e-2 if dtype == "bfloat16" else 2e-4
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(state, s_want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_runs_give_the_same_bits(cuda, dtype):
    case = ssd_case(13, 1, 300, 48, 64, 1, 128, dtype, cuda, True)
    y, state = ops.ssd(**case)
    for _ in range(2):
        y2, s2 = ops.ssd(**case)
        assert torch.equal(y2, y) and torch.equal(s2, state)


def quantize_case(seed, n, kind):
    """An fp32 gradient bucket of length ``n`` and its scale as the wire
    computes it (absmax / 127 + 1e-12, fp32).  ``ties`` puts half the
    elements on exact .5 multiples of a power-of-two scale; ``zero`` is
    an all-zero bucket, whose scale is 1e-12."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    x = torch.from_numpy(x)
    scale = x.abs().max() / torch.tensor(127.0) + 1e-12
    if kind == "ties":
        scale = torch.tensor(2.0 ** -10)
        k = torch.from_numpy(rng.integers(-127, 127, n)).float() + 0.5
        x = torch.where(torch.arange(n) % 2 == 0, k * scale, x)
    return x, scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,kind", [
    (2_781_056, "normal"),        # qwen2-0.5b's smallest gradient bucket
    (4096 * 37 + 3, "normal"),    # ragged against 4 and against 32x128
    (5, "ties"), (100_003, "ties"), (4096, "zero"), (1, "normal")])
def test_quantize_kernel_matches_plain_bitwise(cuda, n, kind):
    from repro_torch.kernels import fused
    x, scale = quantize_case(n % 1000, n, kind)
    want = ref.quantize_int8(x, scale)
    before = fused.launches
    got = ops.quantize_int8(x.to(cuda), scale.to(cuda))
    assert fused.launches == before + 1 and got.dtype == torch.int8
    assert torch.equal(got.cpu(), want)
    # and from a bucket that does not start on a 16-byte boundary
    xo = torch.cat([torch.zeros(1), x]).to(cuda)[1:]
    assert torch.equal(ops.quantize_int8(xo, scale.to(cuda)).cpu(), want)


def compress_case(seed, n, dtype, kind):
    """An input of ``quantize_compress`` (its scale comes from itself).
    ``ties``: the largest magnitude 127 * 2^-10, whose scale is exactly
    2^-10, and every other element an exact .5 multiple of it, so
    round-half-to-even decides; ``zero``: all zeros (scale fl32(1e-12));
    ``negative``: the largest magnitude is a negative element."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(n) * 1e-3).astype(np.float32))
    if kind == "zero":
        x.zero_()
    if kind == "ties":
        k = torch.from_numpy(rng.integers(-127, 127, n)).float() + 0.5
        x = torch.where(torch.arange(n) % 2 == 0, k * 2.0 ** -10, x * 0.1)
        x[n // 2] = 127 * 2.0 ** -10
        assert float(ref.int8_scale(x.abs().max())) == 2.0 ** -10
    if kind == "negative":
        x[n // 3] = -2 * float(x.abs().max())
    return x.to(TDT[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,kind", [
    (896, "float32", "normal"),           # qwen2-0.5b's smallest leaf
    (4_358_144, "float32", "normal"),     # a layer's MLP weight, 4864 x 896
    (4096 * 37 + 3, "float32", "normal"), (4096 * 37 + 3, "bfloat16",
                                           "normal"),
    (1, "bfloat16", "normal"), (5, "float32", "ties"),
    (100_003, "float32", "ties"), (4097, "float32", "zero"),
    (1000, "float32", "negative")])
def test_quantize_compress_kernel_matches_plain_bitwise(cuda, n, dtype,
                                                        kind):
    from repro_torch.kernels import fused
    x = compress_case(n % 1000, n, dtype, kind)
    qw, sw = ref.quantize_compress(x)
    before = fused.compress_launches
    q, s = ops.quantize_compress(x.to(cuda))
    assert fused.compress_launches == before + 1
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert torch.equal(q.cpu(), qw) and torch.equal(s.cpu(), sw)
    # and from an input that does not start on a 16-byte boundary
    xo = torch.cat([torch.zeros(1, dtype=x.dtype), x]).to(cuda)[1:]
    q, s = ops.quantize_compress(xo)
    assert torch.equal(q.cpu(), qw) and torch.equal(s.cpu(), sw)


def _same_bits(x, y):
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(x.view(ints), y.view(ints))


def ef_case(seed, n, dtype, kind):
    """(g, err) of the error-feedback form: g is ``compress_case``'s
    input, err N(0, 1e-5) (1e-2 of g's scale); ``zero``: err zero too;
    ``ties``: err a whole multiple of 2^-10 at the even elements and g =
    x - err there (exact in fp32), so v = g + err keeps the ties."""
    x = compress_case(seed, n, "float32", kind)
    rng = np.random.default_rng(seed + 1)
    err = torch.from_numpy((rng.standard_normal(n) * 1e-5).astype(np.float32))
    if kind == "zero":
        err.zero_()
    if kind == "ties":
        even = torch.arange(n) % 2 == 0
        j = torch.from_numpy(rng.integers(-3, 4, n)).float()
        err = torch.where(even, j * 2.0 ** -10, err)
        err[n // 2] = 0.0
        x = torch.where(even, x - err, x)
    return x.to(TDT[dtype]), err


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,kind", [
    (896, "bfloat16", "normal"),          # qwen2-0.5b's smallest leaf
    (4_358_144, "bfloat16", "normal"),    # a layer's MLP weight, 4864 x 896
    (4096 * 37 + 3, "float32", "normal"), (4096 * 37 + 3, "bfloat16",
                                           "normal"),
    (1, "bfloat16", "normal"), (5, "float32", "ties"),
    (100_003, "float32", "ties"), (4097, "float32", "zero"),
    (1000, "float32", "negative")])
def test_quantize_compress_ef_kernel_matches_plain_bitwise(cuda, n, dtype,
                                                           kind):
    """The error-feedback form: deq, new_err and the scale bitwise its
    plain version's, g and err left as they were, one count under
    ``quantize_compress``; also from inputs that do not start on a
    16-byte boundary (the kernels' element path)."""
    from repro_torch.kernels import fused
    g, err = ef_case(n % 1000, n, dtype, kind)
    want = ref.quantize_compress_ef(g, err)
    gc, ec = g.to(cuda), err.to(cuda)
    before = fused.compress_launches
    got = ops.quantize_compress_ef(gc, ec)
    assert fused.compress_launches == before + 1
    assert all(_same_bits(x.cpu(), w) for x, w in zip(got, want))
    assert torch.equal(gc.cpu(), g) and torch.equal(ec.cpu(), err)
    go = torch.cat([torch.zeros(1, dtype=g.dtype), g]).to(cuda)[1:]
    eo = torch.cat([torch.zeros(1), err]).to(cuda)[1:]
    got = ops.quantize_compress_ef(go, eo)
    assert all(_same_bits(x.cpu(), w) for x, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (8, 896, 4864), (8, 4864, 896), (8, 896, 128),    # qwen2-0.5b decode
    (128, 896, 896), (8, 1024, 1024),                 # prefill, bench
    (5, 300, 77), (130, 257, 129)])                   # ragged
def test_matmul_dequant_kernel_matches_plain(cuda, m, k, n):
    """At the reference test's tolerances: fp32 activations 2e-5, bf16
    activations (and any bf16 output) 2e-2."""
    from repro_torch.kernels import gemm
    g = torch.Generator().manual_seed(m * k + n)
    w = torch.randn((k, n), generator=g) * 0.05
    bq, bs = (t.to(cuda) for t in ops.quantize_int8_per_channel(w))
    for dtype in ("float32", "bfloat16"):
        a = torch.randn((m, k), generator=g).to(TDT[dtype]).to(cuda)
        for out in (torch.float32, torch.bfloat16):
            before = gemm.dequant_launches
            got = ops.matmul_dequant(a, bq, bs, out)
            assert gemm.dequant_launches == before + 1
            assert got.dtype == out and got.shape == (m, n)
            tol = TOL["float32" if dtype == "float32"
                      and out == torch.float32 else "bfloat16"]
            torch.testing.assert_close(
                got.float(), ref.matmul_dequant(a, bq, bs, out).float(),
                **tol)


DEQUANT_SHAPES = [
    (8, 896, 4864), (8, 4864, 896), (8, 896, 128),    # qwen2-0.5b decode
    (128, 896, 896), (8, 1024, 1024),                 # prefill, bench
    (5, 300, 77), (130, 257, 129)]                    # ragged


def _dequant_case(m, k, n, dtype, cuda):
    g = torch.Generator().manual_seed(m * k + n + 1)
    w = torch.randn((k, n), generator=g) * 0.05
    bq, bs = (t.to(cuda) for t in ops.quantize_int8_per_channel(w))
    a = torch.randn((m, k), generator=g).to(TDT[dtype]).to(cuda)
    return a, bq, bs


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", DEQUANT_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matmul_dequant_kernel_is_bitwise_the_widened_matmul(cuda, m, k, n,
                                                             dtype):
    """The kernel runs the GEMM's mainloop under the same plan as
    ``matmul`` on the weights widened to the activations' type, so its
    result is that product in fp32 times the scale, cast once, bitwise;
    and a second run gives the same bits."""
    from repro_torch.kernels import gemm
    a, bq, bs = _dequant_case(m, k, n, dtype, cuda)
    for out in (torch.float32, torch.bfloat16):
        got = ops.matmul_dequant(a, bq, bs, out)
        want = (gemm.matmul(a, bq.to(a.dtype), torch.float32)
                * bs[None, :]).to(out)
        assert _same_bits(got, want)
        assert _same_bits(got, ops.matmul_dequant(a, bq, bs, out))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(896, 4864), (4864, 896), (257, 129)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matmul_dequant_rows_are_invariant_bitwise(cuda, k, n, dtype):
    """Row i of C depends on A[i], B, K and N only: rows of an M = 1, 8,
    44 or 65 call equal those rows inside an M = 128 call."""
    a, bq, bs = _dequant_case(128, k, n, dtype, cuda)
    full = ops.matmul_dequant(a, bq, bs, torch.float32)
    for m in (1, 8, 44, 65):
        part = ops.matmul_dequant(a[:m].contiguous(), bq, bs, torch.float32)
        assert _same_bits(part, full[:m])


BWD_CASES = [
    # (B, Hq, Hkv, S, T, q_offset, window, softcap)
    (2, 14, 2, 512, 512, 0, None, None),     # the qwen2-0.5b train shape
    (1, 4, 2, 37, 100, 63, None, None),      # ragged, query offset
    (2, 6, 3, 96, 96, 0, 24, None),          # sliding window
    (1, 4, 1, 64, 64, 0, None, 5.0),         # softcap
    (1, 2, 1, 16, 40, 20, 1, None),          # rows with no visible key
]


def _grads_close(got, want):
    """bf16 gradients: within 3e-2 of each value plus 2e-2 of the largest
    (the kernel's products use O and dO rounded to bf16, the plain
    autograd the fp32 values, and sums run in another order)."""
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=3e-2,
                                   atol=2e-2 * float(w.abs().max()) + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("B,hq,hkv,s,t,off,window,softcap", BWD_CASES)
def test_attention_backward_kernel_matches_plain(cuda, B, hq, hkv, s, t, off,
                                                 window, softcap):
    from repro_torch.kernels import flash_attention as fa
    q = _bf16(10, (B, hq, s, 64), cuda)
    k, v = _bf16(11, (B, hkv, t, 64), cuda), _bf16(12, (B, hkv, t, 64), cuda)
    d_out = _bf16(13, (B, hq, s, 64), cuda)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=off)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fa.launches, fa.bwd_launches)
    out = ops.attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, d_out)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = ref.attention_backward(q, k, v, d_out, **kw)
    _grads_close(got, want)
    if window == 1:                 # rows 20.. see no key: zero gradients
        assert (got[0][:, :, 20:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1024, 896, 896), (1024, 896, 128),
                                   (1024, 4864, 896), (1024, 896, 151_936),
                                   (70, 130, 66)])
def test_gemm_backward_kernel_matches_plain(cuda, m, k, n):
    """dA and dB of ``matmul`` (fp32 result) on the kernel against the
    plain version's, both from the cotangent rounded to bf16."""
    from repro_torch.kernels import gemm
    a, b = _bf16(20, (m, k), cuda), _bf16(21, (k, n), cuda, 0.05)
    dc = torch.randn((m, n), generator=torch.Generator().manual_seed(22)
                     ).to(cuda)
    got = torch.autograd.grad(
        ops.matmul(a.requires_grad_(True), b.requires_grad_(True),
                   torch.float32), (a, b), dc)
    before = gemm.launches
    g = dc.to(torch.bfloat16)
    want = (ref.matmul(g, b.detach().t(), torch.bfloat16),
            ref.matmul(a.detach().t(), g, torch.bfloat16))
    assert gemm.launches == before
    _grads_close(got, want)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run("qwen2-0.5b", scheduler="continuous")
    assert Model(cfg, device="cpu").device == torch.device("cpu")


def test_wrappers_refuse_mixed_devices():
    a = torch.zeros(4, 4, dtype=torch.bfloat16)
    b = torch.zeros(4, 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ops.matmul(a, b)
    q = torch.zeros(1, 2, 4, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ops.attention(q, q, q)
    case = ssd_case(0, 1, 8, 2, 4, 1, 4, "float32")
    with pytest.raises(ValueError):          # one tensor off the CPU
        ops.ssd(**dict(case, A=case["A"].to("meta")))
    with pytest.raises(ValueError):          # the scale off the CPU
        ops.quantize_int8(torch.zeros(8), torch.ones((), device="meta"))
    with pytest.raises(ValueError):
        ops.quantize_compress(torch.zeros(8, device="meta"))
    bq = torch.zeros(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError):          # the scales off the CPU
        ops.matmul_dequant(torch.zeros(2, 4), bq, torch.ones(3,
                                                             device="meta"))


def test_build_digest_follows_headers(tmp_path):
    """The library is rebuilt when a ``.cuh`` header the sources include
    changes, not only a ``.cu`` source."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh", "ssd_scan.cuh"]
    before = _build.source_digest(csrc)
    assert _build.source_digest(csrc) == before == _build.source_digest()
    for h in headers:
        h.write_bytes(h.read_bytes() + b"\n")
        after = _build.source_digest(csrc)
        assert after != before
        before = after


def test_profiler_families_match_kernel_names():
    """Every pattern of ``chip_smoke.py``'s profiled kernel families names
    a ``__global__`` kernel of ``csrc/`` (``memcpy`` names the copies), so
    a rename cannot move a kernel's time into ``other`` unseen."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "device_breakdown")
    fams = next(ast.literal_eval(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "fams")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        "\n".join(f.read_text() for f in csrc.glob("*.cu"))))
    assert {"flash_attention_wgmma_kernel", "attn_bwd_dq_kernel"} <= names
    assert set(fams) >= {"gemm", "attention", "attention_backward"}
    for fam, pats in fams.items():
        if fam == "memcpy":
            continue
        for pat in pats:
            assert any(pat in n for n in names), (fam, pat)
    # no kernel counts in two families
    for n in names:
        assert sum(any(p in n for p in pats) for f, pats in fams.items()
                   if f != "memcpy") <= 1, n


def _kernel_names_in_launch_order(path):
    """``path``'s ``__global__`` kernels, in the order they are launched."""
    src = path.read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src)
    return sorted(names, key=lambda n: src.rindex(n))


@pytest.mark.parametrize("const, cu", [
    ("ATTN_BWD_PASSES", "flash_attention_bwd.cu"),
    ("PAGED_PASSES", "paged_attention.cu"),
    ("SSD_PASSES", "ssd_scan.cu"),
    ("SSD_BWD_PASSES", "ssd_scan_bwd.cu")])
def test_profiled_passes_name_kernels_in_launch_order(const, cu):
    """``chip_smoke.py``'s ``pass_us`` names a call's kernels in launch
    order: each name of a pass list picks out exactly one kernel of its
    source, and the list follows the order of the launches (the last
    mention of each kernel's name in the file is at its launch)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    passes = next(ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == const)
    kernels = _kernel_names_in_launch_order(
        ROOT / "src" / "repro_torch" / "kernels" / "csrc" / cu)
    picked = []
    for p in passes:
        hits = [k for k in kernels if p in k]
        assert len(hits) == 1, (p, hits)
        picked.append(hits[0])
    assert picked == [k for k in kernels if k in picked]


def test_ssd_bwd_phase_marks_match_the_script():
    """``scripts/ssd_bwd_phases.py`` names the phases that the SSD
    backward's ``PHASE(k)`` marks close: each kernel opens its clock once
    and closes phases 1, 2, ... in source order, one name each."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "ssd_scan_bwd.cu").read_text()
    script = ast.parse((ROOT / "scripts" / "ssd_bwd_phases.py").read_text())
    named = {n.targets[0].id: ast.literal_eval(n.value) for n in script.body
             if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) in ("STATE", "CHUNK")}
    a = src.index("ssd_bwd_state_kernel(")
    b = src.index("ssd_bwd_chunk_kernel(")
    c = src.index("ssd_bwd_sum_kernel(")
    for k, body, names in ((1, src[a:b], named["STATE"]),
                           (0, src[b:c], named["CHUNK"])):
        assert re.findall(r"PHASE_INIT\((\d+)\)", body) == [str(k)]
        marks = [int(m) for m in re.findall(r"\bPHASE\((\d+)\)", body)]
        assert marks == list(range(1, len(names) + 1))
    # compiled out unless asked for
    assert "#ifdef SSD_BWD_PHASES" in src
    assert re.search(r"#else\s+#define PHASE_INIT\(K\)\s+#define PHASE\(k\)"
                     r"\s+#endif", src)


def test_port_imports_neither_jax_nor_the_reference():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)\b"
                     r"(?!_torch)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "scripts").glob("*.py"))
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in bad.finditer(f.read_text())]
    assert hits == []


# ---------------------------------------------------------------------------
# Copies pinned to their originals
# ---------------------------------------------------------------------------

def _config_matches_reference(J, arch):
    want = J.base.get_config(arch)
    got = get_config(arch)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.padded_vocab, got.d_head, got.param_count()) == \
        (want.padded_vocab, want.d_head, want.param_count())
    assert [got.is_global_layer(i) for i in range(got.n_layers)] == \
        [want.is_global_layer(i) for i in range(want.n_layers)]
    for down in (1, 2, 8, 64):
        assert dataclasses.asdict(tbase.scale_config(got, down)) == \
            dataclasses.asdict(J.base.scale_config(want, down))


def test_qwen2_config_matches_reference_field_by_field(J):
    _config_matches_reference(J, "qwen2-0.5b")
    assert tbase.ARCH_IDS == J.base.ARCH_IDS
    assert tbase.SHAPES == {k: tbase.ShapeConfig(*dataclasses.astuple(v))
                            for k, v in J.base.SHAPES.items()}


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-14b", "gemma3-27b"])
def test_dense_family_configs_match_reference_field_by_field(J, arch):
    """The dense family's config modules, copied from the reference's and
    registered as it registers them."""
    _config_matches_reference(J, arch)
    assert get_config(arch) is tbase._REGISTRY[arch]


def _defs(module, skip=()):
    """Top-level functions/classes of a module as AST dumps, docstrings
    stripped (the copies reword only their docstrings)."""
    tree = ast.parse(inspect.getsource(module))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name not in skip:
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if isinstance(body, list) and body \
                        and isinstance(body[0], ast.Expr) \
                        and isinstance(body[0].value, ast.Constant) \
                        and isinstance(body[0].value.value, str):
                    sub.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


@pytest.mark.parametrize("name,tmod,skip", [
    ("blocks", tblocks, ()),
    ("scheduler", tscheduler, ()),
    ("base", tbase, ("get_config", "cells")),
])
def test_copied_modules_match_their_originals(J, name, tmod, skip):
    assert _defs(tmod, skip) == _defs(getattr(J, name), skip)
