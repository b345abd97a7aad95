"""The attention kernels at every head dim up to 256, and the paged-decode
kernel's shard mode with the combine of the ranks' partials.

- On the CPU: the plain shard-mode decode (``ref.paged_decode_partials``)
  on each rank's shard plus the plain combine equals the one-rank plain
  decode over the whole row within fp32 rounding (then the bf16 output's
  rounding): shards of a dense row at offsets, shards of a page pool by
  page, a shard with no live position, a fully masked row, head dims 40
  and 42; the continuous engine's pool on a mesh, each rank's pages in
  its own pool (``attention.page_shard``).  The wrappers take any head
  dim up to 256 (a dry trace on fake tensors runs their checks) and
  refuse past it.
- On the card (``gpu``): flash attention forward (bf16 and fp32) and
  backward and the paged decode at D = 40, 42, 48, 56, 160 and 168
  against their plain versions at the repo's bf16 tolerances (3e-2
  relative, 2e-2 absolute; fp32 2e-5 relative); the shard-mode kernel's
  partials against the plain ones, the combine kernel against the plain
  combine, both the same bits run to run, on dense shards and on the
  pool sharded by page; and a row sharded at multiples of the 128-key
  split gives the one-rank call's bits exactly.
"""

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as paged  # noqa: E402

ODD_DIMS = (40, 42, 48, 56, 160, 168)
BF16 = dict(rtol=3e-2, atol=2e-2)


def _rand(seed, shape, device="cpu", dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _dense_shards(q, k, v, lens, n):
    """Each of ``n`` ranks' shard-mode partials of dense rows k, v (B, T,
    Hkv, hd) cut into n contiguous shards, lengths clipped to each."""
    B, T = k.shape[:2]
    t = T // n
    table = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    parts = []
    for r in range(n):
        local = (lens.long() - r * t).clamp(0, t).to(torch.int32)
        parts.append(ops.paged_decode_partials(
            q, k[:, r * t:(r + 1) * t].contiguous(),
            v[:, r * t:(r + 1) * t].contiguous(), table, local))
    return torch.stack(parts), -(-t // paged.SPLIT)


@pytest.mark.parametrize("hd", [16, 40, 42])
@pytest.mark.parametrize("n,T,lens", [
    (4, 512, (1, 130, 300, 512)),      # ranks 1-3 empty for the first row
    (2, 64, (5, 64, 33, 1)),
    (4, 32, (0, 3, 32, 9)),            # a row with no live position
])
def test_plain_shards_and_combine_equal_the_one_rank_decode(hd, n, T, lens):
    B, Hq, Hkv = 4, 6, 2
    q = _rand(1, (B, Hq, hd))
    k, v = _rand(2, (B, T, Hkv, hd)), _rand(3, (B, T, Hkv, hd))
    lens = torch.tensor(lens, dtype=torch.int32)
    parts, splits = _dense_shards(q, k, v, lens, n)
    got = ops.paged_decode_combine(parts, B, Hq, hd, splits)
    table = torch.arange(B, dtype=torch.int32)[:, None]
    want = ref.paged_decode_attention(q, k, v, table, lens.clamp(min=1))
    want = torch.where((lens > 0)[:, None, None], want.float(), 0.0)
    torch.testing.assert_close(got.float(), want, rtol=8e-3, atol=1e-6)
    assert torch.equal(got[lens == 0].float(),
                       torch.zeros_like(got[lens == 0].float()))


@pytest.mark.parametrize("hd", [32, 42])
def test_plain_page_shards_and_combine_equal_the_one_rank_decode(hd):
    """A pool sharded by page (page p > 0 on rank (p - 1) % n), the table
    global: each rank masks the pages it does not hold."""
    B, Hq, Hkv, page, nb, n = 3, 8, 2, 16, 12, 3
    P = B * nb + 1
    q = _rand(4, (B, Hq, hd))
    kp, vp = _rand(5, (P, page, Hkv, hd)), _rand(6, (P, page, Hkv, hd))
    table = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(7))
             + 1).reshape(B, nb).to(torch.int32)
    lens = torch.tensor([1, 100, nb * page], dtype=torch.int32)
    parts = [ops.paged_decode_partials(
        q, kp, vp, torch.where((table - 1) % n == r, table, -1).to(
            torch.int32), lens) for r in range(n)]
    got = ops.paged_decode_combine(torch.stack(parts), B, Hq, hd,
                                   paged.splits_of(nb, page))
    want = ref.paged_decode_attention(q, kp, vp, table, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-6)


def test_partials_layout_is_o_then_m_then_l():
    """One split of one head: m is the max scaled score in log2 units, l
    the sum of 2^(s - m), o the unnormalised sum of 2^(s - m) v."""
    q, k = _rand(8, (1, 1, 8)), _rand(9, (1, 5, 1, 8))
    v = _rand(10, (1, 5, 1, 8))
    lens = torch.tensor([5], dtype=torch.int32)
    table = torch.zeros((1, 1), dtype=torch.int32)
    part = ref.paged_decode_partials(q, k, v, table, lens)
    assert part.shape == (8 + 2,)
    s = (k[0, :, 0].float() @ q[0, 0].float()) / 8 ** 0.5 * ref.LOG2E
    m = s.max()
    p = torch.exp2(s - m)
    torch.testing.assert_close(part[8], m)
    torch.testing.assert_close(part[9], p.sum())
    torch.testing.assert_close(part[:8], p @ v[0, :, 0].float())


@pytest.mark.parametrize("hd", [40, 42, 168, 256])
def test_wrappers_take_every_head_dim_up_to_256(hd):
    """A dry trace (fake tensors) runs the wrappers' checks: any head dim
    up to 256 passes, past it they refuse."""
    with FakeTensorMode():
        q = torch.empty((1, 4, 16, hd), dtype=torch.bfloat16)
        k = torch.empty((1, 2, 16, hd), dtype=torch.bfloat16)
        assert ops.attention(q, k, k).shape == q.shape
        qd = torch.empty((2, 4, hd), dtype=torch.bfloat16)
        pool = torch.empty((3, 16, 2, hd), dtype=torch.bfloat16)
        table = torch.empty((2, 1), dtype=torch.int32)
        lens = torch.empty((2,), dtype=torch.int32)
        assert ops.paged_decode_attention(qd, pool, pool, table,
                                          lens).shape == qd.shape
        part = ops.paged_decode_partials(qd, pool, pool, table, lens)
        assert part.shape == (2 * 4 * 1 * (hd + 2),)
    with FakeTensorMode(), pytest.raises(ValueError):
        big = torch.empty((1, 4, 16, 264), dtype=torch.bfloat16)
        ops.attention(big, big[:, :2], big[:, :2])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _grads_close(got, want):
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=3e-2,
                                   atol=2e-2 * float(w.abs().max()) + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("d", ODD_DIMS)
def test_flash_odd_head_dims_match_plain(cuda, d):
    """Forward with its log-sum-exp and backward on the tile of the next
    width, a prefill chunk against an offset and a causal train shape."""
    for s, t, off in ((37, 100, 50), (128, 128, 0)):
        q = _rand(11, (2, 4, s, d), cuda)
        k, v = _rand(12, (2, 2, t, d), cuda), _rand(13, (2, 2, t, d), cuda)
        kw = dict(causal=True, q_offset=off)
        torch.testing.assert_close(ops.attention(q, k, v, **kw).float(),
                                   ref.attention(q, k, v, **kw).float(),
                                   **BF16)
        d_out = _rand(14, (2, 4, s, d), cuda)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad(ops.attention(*leaves, **kw), leaves, d_out)
        _grads_close(got, ref.attention_backward(q, k, v, d_out, **kw))
        qf, kf, vf = (x.float() for x in (q, k, v))
        torch.testing.assert_close(ops.attention(qf, kf, vf, **kw),
                                   ref.attention(qf, kf, vf, **kw),
                                   rtol=2e-5, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", ODD_DIMS)
def test_paged_odd_head_dims_match_plain(cuda, d):
    B, Hq, Hkv, page, nb = 3, 14, 2, 64, 4
    P = B * nb + 1
    q = _rand(15, (B, Hq, d), cuda)
    kp, vp = _rand(16, (P, page, Hkv, d), cuda), _rand(17, (P, page, Hkv, d),
                                                       cuda)
    table = (torch.arange(B * nb) + 1).reshape(B, nb).to(torch.int32).to(cuda)
    lens = torch.tensor([1, 129, nb * page], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, table, lens).float(),
        ref.paged_decode_attention(q, kp, vp, table, lens).float(), **BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 42])
def test_shard_kernel_and_combine_match_plain(cuda, hd):
    """qwen2's decode on four shards of a 2,048-position row: the kernel's
    partials against the plain ones (m, l at fp32 rounding of bf16
    products; o at the bf16 rule: P is rounded to bf16 for P·V), the
    combine kernel against the plain combine on the same partials, both
    the same bits run to run (o where l = 0 is left unwritten by the
    kernel: compared as :func:`ref.live_partials` zeroes it)."""
    B, Hq, Hkv, T, n = 8, 14, 2, 2048, 4
    q = _rand(18, (B, Hq, hd), cuda)
    k, v = _rand(19, (B, T, Hkv, hd), cuda), _rand(20, (B, T, Hkv, hd), cuda)
    lens = torch.tensor([1, 300, 512, 513, 1000, 1536, 2000, 2048],
                        dtype=torch.int32, device=cuda)
    parts, splits = _dense_shards(q, k, v, lens, n)
    t = T // n
    table = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    per = B * Hq * splits
    for r in range(n):
        local = (lens.long() - r * t).clamp(0, t).to(torch.int32)
        want = ref.paged_decode_partials(q, k[:, r * t:(r + 1) * t],
                                         v[:, r * t:(r + 1) * t], table,
                                         local)
        got = ref.live_partials(parts[r], B, Hq, hd, splits)
        torch.testing.assert_close(got[per * hd:], want[per * hd:],
                                   rtol=1e-2, atol=1e-3)
        torch.testing.assert_close(got[:per * hd], want[:per * hd], **BF16)
        again, _ = _dense_shards(q, k, v, lens, n)
        assert torch.equal(ref.live_partials(again, B, Hq, hd, splits),
                           ref.live_partials(parts, B, Hq, hd, splits))
    got = ops.paged_decode_combine(parts, B, Hq, hd, splits)
    want = ref.paged_decode_combine(parts, B, Hq, hd, splits)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)
    assert torch.equal(ops.paged_decode_combine(parts, B, Hq, hd, splits),
                       got)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_shards_at_split_multiples_are_the_one_rank_bits(cuda, hd):
    """Shards of 512 positions give every 128-key split to one rank: the
    ranks' partials in rank order are the one-rank call's splits, and the
    combine adds them as the one-rank call does, bit for bit."""
    B, Hq, Hkv, T = 8, 14, 2, 2048
    q = _rand(21, (B, Hq, hd), cuda)
    k, v = _rand(22, (B, T, Hkv, hd), cuda), _rand(23, (B, T, Hkv, hd), cuda)
    lens = torch.tensor([1, 128, 129, 511, 512, 900, 1800, 2048],
                        dtype=torch.int32, device=cuda)
    parts, splits = _dense_shards(q, k, v, lens, 4)
    got = ops.paged_decode_combine(parts, B, Hq, hd, splits)
    table = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    assert torch.equal(got, ops.paged_decode_attention(q, k, v, table, lens))


@pytest.mark.parametrize("hd", [64, 42])
@pytest.mark.parametrize(
    "where", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_page_sharded_kernel_and_combine_match_plain(where, hd):
    """The continuous engine's layout on a mesh: 8 slots of 2,048 on
    pages of 64, each row's live pages from a shuffled global pool, the
    tail on the NULL page, 4 ranks each holding every fourth page (about
    three of four table entries -1).  Each rank's partials against the
    plain ones on its own pool, the combine against the plain combine,
    both the same bits run to run, and the combine against the one-rank
    plain decode over the global pool.  On the CPU the wrappers run the
    plain versions: the layout and the masking are what is held."""
    from repro_torch.models import attention
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cuda = torch.device(where)
    B, Hq, Hkv, page, nb, n = 8, 14, 2, 64, 32, 4
    lens = [1, 64, 65, 300, 777, 1024, 1500, 2048]
    used = [-(-x // page) for x in lens]
    ids = torch.randperm(sum(used), generator=torch.Generator()
                         .manual_seed(24)) + 1
    table = torch.zeros((B, nb), dtype=torch.int32)
    for b, u in enumerate(used):
        table[b, :u] = ids[sum(used[:b]):sum(used[:b]) + u]
    P = sum(used) + 1
    q = _rand(25, (B, Hq, hd), cuda)
    kg, vg = _rand(26, (P, page, Hkv, hd), cuda), _rand(27, (P, page, Hkv,
                                                             hd), cuda)
    table, lens = table.to(cuda), torch.tensor(lens, dtype=torch.int32,
                                               device=cuda)
    splits = paged.splits_of(nb, page)
    per = B * Hq * splits
    shards = []
    for r in range(n):
        held, local = attention.page_shard(table, n, r)
        tb = torch.where(held, local, -1).to(torch.int32)
        mine = torch.arange(r + 1, P, n, device=cuda)
        pools = []
        for whole in (kg, vg):
            pool = torch.zeros((attention.local_pages(P, n),)
                               + whole.shape[1:], dtype=whole.dtype,
                               device=cuda)
            pool[(mine - 1) // n + 1] = whole[mine]
            pools.append(pool)
        shards.append((*pools, tb))

    def partials():
        return torch.stack([ops.paged_decode_partials(q, kp, vp, tb, lens)
                            for kp, vp, tb in shards])

    parts = partials()
    for r, (kp, vp, tb) in enumerate(shards):
        got = ref.live_partials(parts[r], B, Hq, hd, splits)
        want = ref.paged_decode_partials(q, kp, vp, tb, lens)
        torch.testing.assert_close(got[per * hd:], want[per * hd:],
                                   rtol=1e-2, atol=1e-3)
        torch.testing.assert_close(got[:per * hd], want[:per * hd], **BF16)
    assert torch.equal(ref.live_partials(partials(), B, Hq, hd, splits),
                       ref.live_partials(parts, B, Hq, hd, splits))
    got = ops.paged_decode_combine(parts, B, Hq, hd, splits)
    torch.testing.assert_close(
        got.float(), ref.paged_decode_combine(parts, B, Hq, hd,
                                              splits).float(),
        rtol=1e-2, atol=1e-3)
    assert torch.equal(ops.paged_decode_combine(parts, B, Hq, hd, splits),
                       got)
    torch.testing.assert_close(
        got.float(), ref.paged_decode_attention(q, kg, vg, table,
                                                lens).float(), **BF16)
