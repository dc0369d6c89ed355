"""The port's CUDA kernels (K1 forward; K2 dq, K3 dk/dv and K4 dq + dbias
backward) against their plain PyTorch versions, on the card. Every test
here needs a CUDA device and skips without one (the kernels have no CPU
mode). This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

K1, K2, K3 and K4 have two kernels each, chosen by dtype: bf16 takes the
tensor-core kernel, f32 the CUDA-core one; the tests count which one
launched. Tolerances are the JAX flash tests': 2e-5 for float32, 2e-2 for
bfloat16 (bf16 operands, and the rounding of p to bf16 in K1, which the
plain version does after normalising and the kernel before); on gradients
1e-4 relative / 1e-5 absolute in float32 (tests/test_flash_attention.py:72)
and 2e-2 in bfloat16. The seg variants (sequence packing) are held to the
same tolerances against the plain versions with seg. The two-card test
skips with fewer than two cards."""
import pytest
import torch

from dnn_page_vectors_tpu_torch.ops import flash_attention as fa

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, B=2, H=2, L=48, S=48, Dh=64, dtype=torch.float32,
            pad_tail=5, bias=False, seg=False, strided=False, unaligned=False,
            seed=0):
    g = torch.Generator().manual_seed(seed)
    if strided:      # [B, L, H, Dh] viewed as [B, H, L, Dh], as the towers do
        q, k, v = (torch.randn(B, n, H, Dh, generator=g).transpose(1, 2)
                   for n in (L, S, S))
    else:
        q, k, v = (torch.randn(B, H, n, Dh, generator=g) for n in (L, S, S))
    mask = torch.ones(B, S, dtype=torch.bool)
    if pad_tail and pad_tail < S:
        mask[:, -pad_tail:] = False
    mask[-1] = False                     # one batch row sees no key at all
    x = {"q": q, "k": k, "v": v, "kv_mask": mask, "bias": None, "seg": None}
    if bias:
        x["bias"] = torch.randn(H, L, S, generator=g)
    if seg:
        ids = torch.zeros(B, L, dtype=torch.int32)
        ids[:, :L // 2] = 1
        ids[:, L // 2:L - pad_tail] = 2
        x["seg"] = ids
    out = {}
    for n, t in x.items():
        if t is None:
            out[n] = None
        elif n in ("q", "k", "v"):
            out[n] = t.to(device=device, dtype=dtype)
            if unaligned:    # base 2 bytes and row stride Dh + 1 off 16 B
                wide = torch.zeros(*t.shape[:-1], Dh + 1, device=device,
                                   dtype=dtype)
                wide[..., 1:] = out[n]
                out[n] = wide[..., 1:]
        else:
            out[n] = t.to(device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(),
    dict(L=37, S=53, pad_tail=7),
    dict(L=40, S=40, pad_tail=6, seg=True),
    dict(H=3, L=32, S=32, bias=True),
    dict(L=130, S=200, Dh=128, bias=True),
    dict(strided=True, dtype=torch.bfloat16),
    dict(B=8, H=4, L=16, S=16, dtype=torch.bfloat16),
], ids=["padding", "ragged", "seg", "bias", "multi_tile_dh128",
        "strided_bf16", "query_bucket_bf16"])
def test_flash_fwd_kernel_matches_plain_version(cuda_device, case):
    x = _inputs(cuda_device, **case)
    before = fa.launches
    out, lse = fa.flash_forward(**x)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_out, want_lse = fa.reference_forward(**x)
    tol = TOL[x["q"].dtype]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    # the batch row with every key masked returns mean(V)
    mean_v = x["v"][-1].float().mean(dim=1, keepdim=True)
    torch.testing.assert_close(out[-1], mean_v.expand_as(out[-1]),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_fwd_kernel_raises_on_bad_input(cuda_device):
    x = _inputs(cuda_device)
    x["q"] = x["q"][..., :12]
    with pytest.raises(ValueError):
        fa.flash_forward(**x)


GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _backward_inputs(device, seed=0, **case):
    x = _inputs(device, seed=seed, **case)
    out, lse = fa.reference_forward(**x)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 1))
    if case.get("strided"):       # the towers' upstream gradient is a view
        g = g.transpose(1, 2).contiguous().transpose(1, 2)
    return x, g.to(device), out, lse


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=64, H=4, L=64, S=64, dtype=torch.bfloat16, strided=True),
    dict(B=64, H=4, L=16, S=16, dtype=torch.bfloat16, strided=True),
    dict(),
    dict(L=37, S=53, pad_tail=7),
    dict(L=37, S=53, pad_tail=7, dtype=torch.bfloat16),
    dict(L=130, S=200, Dh=128),
    dict(strided=True),
], ids=["page_train_bf16", "query_train_bf16", "padding_f32", "ragged_f32",
        "ragged_bf16", "multi_tile_dh128_f32", "strided_f32"])
def test_flash_bwd_kernels_match_plain_version(cuda_device, case):
    x, g, out, lse = _backward_inputs(cuda_device, **case)
    q, k, v, mask = x["q"], x["k"], x["v"], x["kv_mask"]
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa.flash_backward(q, k, v, mask, g, out, lse)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = fa.reference_backward(q, k, v, mask, g, out, lse)
    for name, a, b, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), msg=name,
                                   **GRAD_TOL[q.dtype])
    # the last batch row sees no key: dv = sum_l g / S, and no dq, dk
    S = k.shape[2]
    want_dv = (g[-1].float().sum(dim=1, keepdim=True) / S).expand_as(v[-1])
    torch.testing.assert_close(got[2][-1].float(), want_dv,
                               **GRAD_TOL[q.dtype])
    assert not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.cuda
def test_flash_bwd_kernels_are_bitwise_deterministic(cuda_device):
    x, g, out, lse = _backward_inputs(cuda_device, B=64, H=4, L=64, S=64,
                                      dtype=torch.bfloat16, strided=True)
    args = (x["q"], x["k"], x["v"], x["kv_mask"], g, out, lse)
    first = fa.flash_backward(*args)
    assert first[3] is None
    for _ in range(3):
        again = fa.flash_backward(*args)
        for a, b in zip(first[:3], again[:3]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=64, H=12, L=128, S=128, dtype=torch.bfloat16, strided=True),
    dict(B=64, H=12, L=16, S=16, dtype=torch.bfloat16, strided=True),
    dict(B=11, L=37, S=53, pad_tail=7),
    dict(B=11, L=37, S=53, pad_tail=7, dtype=torch.bfloat16),
    dict(L=130, S=200, Dh=128),
    dict(B=3, strided=True),
], ids=["mt5_page_train_bf16", "mt5_query_train_bf16", "ragged_f32",
        "ragged_bf16", "multi_tile_dh128_f32", "strided_f32"])
def test_biased_bwd_kernels_match_plain_version(cuda_device, case):
    """K4 (dq, dbias) and the biased K3 (dk, dv) against the biased plain
    backward; B=11 is not a multiple of K4's batch group."""
    x, g, out, lse = _backward_inputs(cuda_device, bias=True, **case)
    q, k, v, mask, bias = x["q"], x["k"], x["v"], x["kv_mask"], x["bias"]
    before = (fa.dq_launches, fa.dkv_launches, fa.dq_dbias_launches)
    got = fa.flash_backward(q, k, v, mask, g, out, lse, bias)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches, fa.dq_dbias_launches) == (
        before[0], before[1] + 1, before[2] + 1)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    for name, a, b, t in zip(("dq", "dk", "dv", "dbias"), got, want,
                             (q, k, v, bias)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), msg=name,
                                   **GRAD_TOL[q.dtype])
    # the last batch row sees no key: no dq, dk, and nothing in dbias
    assert not got[0][-1].any() and not got[1][-1].any()
    if q.shape[0] > 1:
        rest = fa.reference_backward(q[:-1], k[:-1], v[:-1], mask[:-1],
                                     g[:-1], out[:-1], lse[:-1], bias)[3]
        torch.testing.assert_close(got[3], rest, **GRAD_TOL[q.dtype])


@pytest.mark.cuda
def test_dq_dbias_kernel_is_bitwise_deterministic(cuda_device):
    x, g, out, lse = _backward_inputs(cuda_device, B=64, H=12, L=128, S=128,
                                      dtype=torch.bfloat16, strided=True,
                                      bias=True)
    args = (x["q"], x["k"], x["v"], x["kv_mask"], x["bias"], g, out, lse)
    first = fa.launch_dq_dbias(*args)
    for _ in range(3):
        again = fa.launch_dq_dbias(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _packed_seg(B, L, pack=4, seed=0):
    """[B, L] int32 segment ids of packed rows: `pack` pages a row, one of
    them a single token, one straddling the 16- and 32-key tile edges, a
    pad tail, and the last batch row all pad."""
    g = torch.Generator().manual_seed(seed)
    seg = torch.zeros(B, L, dtype=torch.int32)
    for b in range(B - 1):
        cuts = sorted(torch.randint(1, L - 2, (pack - 1,),
                                    generator=g).tolist())
        lens = [cuts[0]] + [c1 - c0 for c0, c1 in zip(cuts, cuts[1:])]
        lens[b % len(lens)] = 1
        c = 0
        for s, n in enumerate(lens):
            seg[b, c:c + n] = s + 1
            c += n
        seg[b, c:min(L - 2, c + 20)] = pack     # the last page, then pad
    return seg


def _layout_seg(layout, B, L, pack=4, seed=0):
    """([B, L] int32 segment ids, [B, L] kv mask) of a layout the skipping
    kernels must not trip on, the last batch row all pad in each:
    "packed" (_packed_seg), "interleaved" (ids that are not contiguous:
    runs of random ids from 1 to `pack`, reused along the row, and pads
    between them), "masked_segment" (packed, with every key of segment 2
    masked: its rows see no key), "all_pad" (every other batch row all
    pad), "one_segment" (one segment over the whole row: every tile
    visited), "tail_segment" (pad, then one segment over the last 300
    positions: a Q tile's first KV tile, and a key block's first Q tile,
    lie more than 32 tiles on, past one warp's search), "short_pages"
    (`pack` pages of 1 to 24 tokens, as the packed mT5 cell's 20-word
    pages: at L = 128 the last 32-row Q tile of every row is pad, so K4
    visits no KV tile for it)."""
    if layout == "short_pages":
        g = torch.Generator().manual_seed(seed)
        lens = torch.randint(1, 25, (B, pack), generator=g)
        ends = lens.cumsum(1)
        seg = (torch.arange(L)[None, :, None] >= ends[:, None, :]).sum(-1) + 1
        seg[seg > pack] = 0
        seg[-1] = 0
        seg = seg.to(torch.int32)
        return seg, seg > 0
    if layout == "tail_segment":
        seg = torch.zeros(B, L, dtype=torch.int32)
        seg[:-1, L - 300:] = 3
        return seg, seg > 0
    if layout == "interleaved":
        g = torch.Generator().manual_seed(seed)
        runs = torch.randint(0, pack + 1, (B, -(-L // 3)), generator=g)
        seg = runs.repeat_interleave(3, dim=1)[:, :L].to(torch.int32)
        seg[-1] = 0
        return seg, seg > 0
    if layout == "one_segment":
        seg = torch.ones(B, L, dtype=torch.int32)
        seg[-1] = 0
        return seg, seg > 0
    seg = _packed_seg(B, L, pack, seed)
    if layout == "all_pad":
        seg[::2] = 0
    mask = seg > 0
    if layout == "masked_segment":
        mask &= seg != 2
    return seg, mask


def _seg_backward_inputs(device, B=6, H=2, L=48, Dh=64, dtype=torch.float32,
                         bias=False, strided=False, unaligned=False, seed=0,
                         pack=4, layout="packed"):
    """Packed inputs (kv_mask = seg > 0, as the towers pass it, or the
    mask of `layout`, see _layout_seg) with an upstream gradient and the
    plain forward's out and lse."""
    x = _inputs(device, B=B, H=H, L=L, S=L, Dh=Dh, dtype=dtype, pad_tail=0,
                bias=bias, strided=strided, unaligned=unaligned, seed=seed)
    seg, mask = _layout_seg(layout, B, L, pack, seed)
    x["seg"], x["kv_mask"] = seg.to(device), mask.to(device)
    out, lse = fa.reference_forward(**x)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to(device)
    return x, g, out, lse


# The seg variants of K2, K3 and K4: the packed paths' head shape, head dims
# 8, 24, 40 and 128, the query tile of L=16, an unaligned view, segments
# of one token and across tile edges, a batch that is not a multiple of
# K4's group, both dtypes, with and without the bias.
SEG_CASES = {
    "bert_long_bf16": dict(B=4, H=8, L=256, dtype=torch.bfloat16,
                           strided=True),
    "mt5_bias_bf16": dict(B=6, H=12, L=128, dtype=torch.bfloat16, bias=True,
                          strided=True),
    "dh8_bf16": dict(Dh=8, dtype=torch.bfloat16),
    "dh24_bias_bf16": dict(Dh=24, dtype=torch.bfloat16, bias=True),
    "dh40_bf16": dict(Dh=40, dtype=torch.bfloat16, L=37),
    "dh128_bias_bf16": dict(Dh=128, L=130, dtype=torch.bfloat16, bias=True),
    "dh128_bf16": dict(Dh=128, L=130, dtype=torch.bfloat16),
    "L16_bf16": dict(B=8, L=16, dtype=torch.bfloat16, pack=2),
    "unaligned_bias_bf16": dict(L=53, dtype=torch.bfloat16, bias=True,
                                unaligned=True),
    "odd_batch_bias_bf16": dict(B=11, dtype=torch.bfloat16, bias=True),
    "L16_bias_bf16": dict(B=8, L=16, dtype=torch.bfloat16, bias=True,
                          pack=2),
    "packed_f32": dict(L=130, strided=True),
    "packed_bias_f32": dict(B=11, L=53, bias=True),
    "dh128_f32": dict(Dh=128, L=70),
    # the layouts of _layout_seg, over several tiles of K2 and K3 (ragged:
    # L = S not a multiple of 64)
    "interleaved_bf16": dict(B=4, H=4, L=320, dtype=torch.bfloat16,
                             layout="interleaved"),
    "interleaved_bias_bf16": dict(B=4, H=4, L=160, dtype=torch.bfloat16,
                                  bias=True, layout="interleaved"),
    "masked_segment_bf16": dict(B=5, H=4, L=256, dtype=torch.bfloat16,
                                layout="masked_segment"),
    "masked_segment_bias_bf16": dict(B=5, H=4, L=128, dtype=torch.bfloat16,
                                     bias=True, layout="masked_segment"),
    "all_pad_bf16": dict(B=6, H=4, L=192, dtype=torch.bfloat16,
                         layout="all_pad"),
    "all_pad_bias_bf16": dict(B=6, H=4, L=192, dtype=torch.bfloat16,
                              bias=True, layout="all_pad"),
    "one_segment_bf16": dict(B=3, H=4, L=256, dtype=torch.bfloat16,
                             layout="one_segment"),
    "one_segment_bias_bf16": dict(B=3, H=4, L=256, dtype=torch.bfloat16,
                                  bias=True, layout="one_segment"),
    # K4's pad tails: whole Q tiles that visit nothing, in a batch of 19
    # rows (groups of 8, 8 and 3)
    "short_pages_bias_bf16": dict(B=19, H=12, L=128, dtype=torch.bfloat16,
                                  bias=True, strided=True,
                                  layout="short_pages"),
    "ragged_L203_bf16": dict(B=5, H=4, L=203, dtype=torch.bfloat16),
    "ragged_L203_bias_bf16": dict(B=5, H=4, L=203, dtype=torch.bfloat16,
                                  bias=True),
    "ragged_L451_bias_bf16": dict(B=5, H=4, L=451, dtype=torch.bfloat16,
                                  bias=True),
    "masked_segment_f32": dict(B=5, H=2, L=96, layout="masked_segment"),
    "tail_segment_bf16": dict(B=3, H=2, L=2400, dtype=torch.bfloat16,
                              layout="tail_segment"),
    "long_L2100_bf16": dict(B=3, H=2, L=2100, dtype=torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_bwd_kernels_match_plain_version(cuda_device, case):
    """K2 + K3, or K4 + K3 with the bias, with segment ids against the
    plain backward with them; the all-pad batch row gets dv = sum_l g / S
    and no dq or dk, and every row that sees no key (pad rows, and the
    rows of a segment whose keys are all masked) adds nothing to dq. A
    bf16 call given no summary launches the segment summary kernel once,
    and the dead rows' g sum once."""
    x, g, out, lse = _seg_backward_inputs(cuda_device, **SEG_CASES[case])
    q, k, v, mask, bias, seg = (x[n] for n in ("q", "k", "v", "kv_mask",
                                               "bias", "seg"))
    tc = q.dtype == torch.bfloat16
    counts = lambda: [getattr(fa, n) for n in fa.COUNTERS]
    before = counts()
    got = fa.flash_backward(q, k, v, mask, g, out, lse, bias, seg)
    torch.cuda.synchronize()
    delta = dict(zip(fa.COUNTERS, (a - b for a, b in zip(counts(),
                                                          before))))
    dq_name = "dq_launches" if bias is None else "dq_dbias_launches"
    assert delta[dq_name + "_seg"] == delta["dkv_launches_seg"] == 1
    assert delta[dq_name + ("_tc" if tc else "_f32")] == 1
    assert delta["dkv_launches" + ("_tc" if tc else "_f32")] == 1
    assert delta["seg_summary_launches"] == delta["gdead_launches"] == int(tc)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias, seg)
    names = ("dq", "dk", "dv", "dbias")[:3 if bias is None else 4]
    for name, a, b, t in zip(names, got, want, (q, k, v, bias)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), msg=name,
                                   **GRAD_TOL[q.dtype])
    S = k.shape[2]
    want_dv = (g[-1].float().sum(dim=1, keepdim=True) / S).expand_as(v[-1])
    torch.testing.assert_close(got[2][-1].float(), want_dv,
                               **GRAD_TOL[q.dtype])
    assert not got[0][-1].any() and not got[1][-1].any()
    dead = (lse <= fa.MASKED_ROW_LSE)[..., None].expand_as(got[0])
    assert not got[0][dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["k2_k3", "k3_bias"])
@pytest.mark.parametrize("L,S", [(16, 16), (20, 20), (32, 32), (37, 53),
                                 (64, 64), (128, 128), (203, 203),
                                 (1024, 1024)])
def test_tile_shapes_are_the_librarys(cuda_device, L, S, bias):
    """tile_shapes, which the CPU tests of the visit rule take, is the
    tiles the compiled K1, K2, K3 and (with the bias) K4 choose."""
    assert fa.tile_shapes(L, S, bias) == fa.kernel_tile_shapes(L, S, bias)


@pytest.mark.cuda
def test_seg_launchers_require_the_summary(cuda_device):
    """The bf16 K1, K2, K4 and K3 with seg raise without
    launch_seg_summary's summary (and K1 without its vmean, K3 without
    launch_dead_rows_sum's gdead): they never launch those kernels
    themselves."""
    x, g, out, lse = _seg_backward_inputs(cuda_device, B=3, H=2, L=64,
                                          dtype=torch.bfloat16)
    q, k, v, mask, seg = x["q"], x["k"], x["v"], x["kv_mask"], x["seg"]
    before = (fa.seg_summary_launches, fa.gdead_launches)
    summary, vmean = fa.launch_seg_summary(seg, mask, v)
    for extra in ((), (summary,)):
        with pytest.raises(ValueError, match="summary"):
            fa.launch_forward(q, k, v, mask, None, seg, *extra)
    fa.launch_forward(q, k, v, mask, None, seg, summary, vmean)
    with pytest.raises(ValueError, match="summary"):
        fa.launch_dq(q, k, v, mask, g, out, lse, seg)
    gdead = fa.launch_dead_rows_sum(lse, g)
    delta = fa.launch_dq(q, k, v, mask, g, out, lse, seg, summary)[1]
    for extra in ((), (summary,)):
        with pytest.raises(ValueError, match="summary"):
            fa.launch_dkv(q, k, v, mask, g, lse, delta, None, seg, *extra)
    fa.launch_dkv(q, k, v, mask, g, lse, delta, None, seg, summary, gdead)
    bias = torch.randn(q.shape[1], q.shape[2], k.shape[2], device=q.device)
    with pytest.raises(ValueError, match="summary"):
        fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse, seg)
    fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse, seg, summary)
    assert (fa.seg_summary_launches, fa.gdead_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [False, True], ids=["k4", "k4_seg"])
def test_k4_holds_3_blocks_an_sm_at_mt5s_shape(cuda_device, seg):
    """K4 (and with segment ids, its skip state in shared memory) fits 3
    blocks of 4 warps on an SM at mT5's page shape, L = S = 128, Dh = 64:
    at most 168 registers a thread and 74 KB of shared memory a block."""
    assert fa.dq_blocks_per_sm(True, seg, 128, 128, 64, cuda_device) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "interleaved", "masked_segment",
                                    "all_pad", "one_segment"])
@pytest.mark.parametrize("L", [64, 203, 1024])
def test_seg_summary_kernel_matches_plain_version(cuda_device, layout, L):
    """The segment summary kernel: the summary equals seg_summary exactly
    (L = 203 ends in a part granule), and vmean equals value_mean exactly
    (both sum in f32 in the same order; 0 where the batch row can hold no
    row that sees no key), for v viewed from [B, L, H, Dh] as the towers
    pass it; the dead rows' g sum equals dead_rows_sum exactly (both sum
    in f32 in row order)."""
    x, g, out, lse = _seg_backward_inputs(cuda_device, B=5, H=3, L=L,
                                          dtype=torch.bfloat16, strided=True,
                                          layout=layout)
    before = (fa.seg_summary_launches, fa.gdead_launches)
    summary, vmean = fa.launch_seg_summary(x["seg"], x["kv_mask"], x["v"])
    gdead = fa.launch_dead_rows_sum(lse, g)
    torch.cuda.synchronize()
    assert (fa.seg_summary_launches, fa.gdead_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(summary, fa.seg_summary(x["seg"]))
    assert torch.equal(vmean, fa.value_mean(x["v"], x["kv_mask"], x["seg"]))
    assert torch.equal(gdead, fa.dead_rows_sum(g, lse))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(), dict(bias=True), dict(layout="interleaved"),
    dict(layout="masked_segment", bias=True), dict(layout="all_pad"),
    dict(layout="one_segment"), dict(L=203), dict(L=203, bias=True),
    dict(layout="short_pages", bias=True), dict(L=16, bias=True, pack=2),
], ids=["k2_k3", "k4_k3", "k2_k3_interleaved", "k4_k3_masked_segment",
        "k2_k3_all_pad", "k2_k3_one_segment", "k2_k3_ragged_L203",
        "k4_k3_ragged_L203", "k4_k3_short_pages", "k4_k3_L16"])
def test_seg_bwd_kernels_are_bitwise_deterministic(cuda_device, case):
    x, g, out, lse = _seg_backward_inputs(
        cuda_device, **{**dict(B=19, H=8, L=128, dtype=torch.bfloat16,
                               strided=True), **case})
    args = (x["q"], x["k"], x["v"], x["kv_mask"], g, out, lse, x["bias"],
            x["seg"])
    first = fa.flash_backward(*args)
    for _ in range(3):
        for a, b in zip(first, fa.flash_backward(*args)):
            assert (a is None and b is None) or torch.equal(a, b)


# K1 with seg (the skipping bf16 kernel): the layouts of _layout_seg, a
# ragged L, with and without the bias
K1_SEG_CASES = {
    **{f"{lay}{'_bias' if b else ''}": dict(B=5, H=4, L=256, layout=lay,
                                            bias=b)
       for lay in ("packed", "interleaved", "masked_segment", "all_pad",
                   "one_segment") for b in (False, True)},
    "ragged_L451": dict(B=5, H=4, L=451),
    "ragged_L451_bias": dict(B=5, H=4, L=451, bias=True),
    "tail_segment": dict(B=3, H=2, L=2400, layout="tail_segment"),
    "dh128_bias": dict(B=3, H=2, L=130, Dh=128, bias=True),
    "L16": dict(B=8, H=2, L=16, pack=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_SEG_CASES))
def test_seg_fwd_kernel_matches_plain_version(cuda_device, case):
    """K1 with segment ids (bf16) against reference_forward with them: out
    and lse within 2e-2; at every row that sees no key (pad rows, the
    rows of a segment whose keys are all masked, whole Q tiles that share
    no segment) out is value_mean's mean(V) exactly and lse <= -1e29. One
    call launches the summary kernel once and K1 once, with seg."""
    x, _, want_out, want_lse = _seg_backward_inputs(
        cuda_device, dtype=torch.bfloat16, **K1_SEG_CASES[case])
    counts = lambda: [getattr(fa, n) for n in fa.COUNTERS]
    before = counts()
    out, lse = fa.flash_forward(**x)
    torch.cuda.synchronize()
    delta = dict(zip(fa.COUNTERS, (a - b for a, b in zip(counts(),
                                                          before))))
    assert delta["launches_seg"] == delta["launches_tc"] == 1
    assert delta["seg_summary_launches"] == 1
    tol = TOL[torch.bfloat16]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
    dead = want_lse <= fa.MASKED_ROW_LSE
    assert torch.equal(dead, lse <= fa.MASKED_ROW_LSE)
    torch.testing.assert_close(lse[~dead], want_lse[~dead], rtol=tol,
                               atol=tol)
    vmean = fa.value_mean(x["v"], x["kv_mask"], x["seg"])
    want_dead = vmean[:, :, None, :].expand_as(out)[dead]
    assert torch.equal(out[dead], want_dead)
    torch.testing.assert_close(want_out[dead], want_dead, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_seg_fwd_kernel_q_tile_with_no_segment(cuda_device):
    """Q tiles whose rows share no segment with any key (the first 192
    positions pad, then one page) visit no KV tile and still write every
    row: mean(V) and the lse of a row that sees no key."""
    x, _, want_out, want_lse = _seg_backward_inputs(
        cuda_device, B=2, H=2, L=512, dtype=torch.bfloat16)
    seg = torch.zeros(2, 512, dtype=torch.int32, device=cuda_device)
    seg[:, 192:400] = 1
    x["seg"], x["kv_mask"] = seg, seg > 0
    out, lse = fa.flash_forward(**x)
    want_out, want_lse = fa.reference_forward(**x)
    torch.cuda.synchronize()
    vmean = fa.value_mean(x["v"], x["kv_mask"], seg)
    assert torch.equal(out[:, :, :192],
                       vmean[:, :, None, :].expand(-1, -1, 192, -1))
    assert (lse[:, :, :192] <= fa.MASKED_ROW_LSE).all()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse[:, :, 192:400], want_lse[:, :, 192:400],
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "masked_segment_bias",
                                  "all_pad", "ragged_L451"])
def test_seg_fwd_kernel_is_bitwise_deterministic(cuda_device, case):
    x = _seg_backward_inputs(cuda_device, dtype=torch.bfloat16,
                             strided=True, **K1_SEG_CASES[case])[0]
    first = fa.flash_forward(**x)
    for _ in range(3):
        for a, b in zip(first, fa.flash_forward(**x)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["k2_k3", "k4_k3"])
def test_seg_backward_takes_the_forwards_summary(cuda_device, bias):
    """Through autograd, a bf16 call with seg launches the segment summary
    kernel once (in the forward) and the dead rows' g sum once (in the
    backward), whose K2 and K3 take the forward's summary; the gradients
    are flash_backward's given no summary."""
    x, g, _, _ = _seg_backward_inputs(cuda_device, B=4, H=2, L=256,
                                      dtype=torch.bfloat16, bias=bias,
                                      layout="masked_segment")
    leaves = [x[n].detach().requires_grad_(True) for n in ("q", "k", "v")]
    counts = lambda: [getattr(fa, n) for n in fa.COUNTERS]
    before = counts()
    out, lse = fa.flash_forward(*leaves, x["kv_mask"], x["bias"], x["seg"])
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    delta = dict(zip(fa.COUNTERS, (a - b for a, b in zip(counts(),
                                                          before))))
    assert delta["seg_summary_launches"] == delta["gdead_launches"] == 1
    assert delta["launches_seg"] == delta["dkv_launches_seg"] == 1
    want = fa.flash_backward(x["q"], x["k"], x["v"], x["kv_mask"], g,
                             out.detach(), lse, x["bias"], x["seg"])
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_forward_seg_counts_and_matches(cuda_device):
    """K1 with seg counts as a seg launch, at L=S=1024 (bert_long_sp's
    packed row) too."""
    for L, dtype in ((40, torch.float32), (1024, torch.bfloat16)):
        x, _, want_out, want_lse = _seg_backward_inputs(
            cuda_device, B=3, H=2, L=L, dtype=dtype)
        before = fa.launches_seg
        out, lse = fa.flash_forward(**x)
        torch.cuda.synchronize()
        assert fa.launches_seg == before + 1
        tol = TOL[dtype]
        torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
        torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernels_launch_on_a_card_that_is_not_current(cuda_device):
    """K1, K2, K3 and K4 (bf16 and f32) on cuda:1 while cuda:0 is the
    current device: each wrapper launches on the tensors' card, whose
    shared-memory grants are its own, and gives the plain version's
    result."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    for dtype in (torch.bfloat16, torch.float32):
        for bias in (False, True):
            x, g, out, lse = _seg_backward_inputs(other, B=4, H=2, L=96,
                                                  dtype=dtype, bias=bias)
            args = (x["q"], x["k"], x["v"], x["kv_mask"])
            got_out, got_lse = fa.flash_forward(*args, x["bias"], x["seg"])
            got = fa.flash_backward(*args, g, out, lse, x["bias"], x["seg"])
            torch.cuda.synchronize(other)
            assert torch.cuda.current_device() == 0
            tol = TOL[dtype]
            torch.testing.assert_close(got_out, out, rtol=tol, atol=tol)
            want = fa.reference_backward(*args, g, out, lse, x["bias"],
                                         x["seg"])
            for a, b in zip(got, want):
                if b is not None:
                    assert a.device == other
                    torch.testing.assert_close(a.float(), b.float(),
                                               **GRAD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bert", "t5"])
def test_cuda_packed_tower_takes_the_seg_kernels(cuda_device, variant):
    """A packed flash tower on the card (bf16): K1, K2 or K4, and K3 once
    a layer, each with seg and on the tensor cores; its gradients agree
    with the packed dense tower's and are bitwise equal run to run."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.data.loader import pack_segments
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    name = "bert_mini_v5p16" if variant == "bert" else "mt5_multilingual"
    ov = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
          "model.mlp_dim": 128, "model.out_dim": 32, "model.dropout": 0.0,
          "data.page_len": 128}
    towers = {}
    for att in ("flash", "dense"):
        cfg = get_config(name, {**ov, "model.attention": att})
        towers[att] = build_two_tower(cfg, vocab_size=256,
                                      device=cuda_device).train()
    towers["dense"].load_state_dict(towers["flash"].state_dict())
    gen = torch.Generator().manual_seed(0)
    lens = torch.randint(1, 33, (32,), generator=gen)
    enc = torch.randint(1, 256, (32, 128), generator=gen)
    enc[torch.arange(128)[None, :] >= lens[:, None]] = 0
    rows, seg, pos = (torch.from_numpy(t).to(cuda_device)
                      for t in pack_segments(enc.int().numpy(), 4))

    def grads(model):
        model.zero_grad(set_to_none=True)
        model.encode_page(rows, seg=seg, pos=pos, nseg=4).square().sum(
        ).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    counts = lambda: [getattr(fa, n) for n in fa.COUNTERS]
    before = counts()
    flash = grads(towers["flash"])
    delta = dict(zip(fa.COUNTERS, (a - b for a, b in zip(counts(),
                                                          before))))
    dq = "dq_launches" if variant == "bert" else "dq_dbias_launches"
    for n in ("launches", dq, "dkv_launches"):
        assert delta[n] == delta[n + "_seg"] == delta[n + "_tc"] == 2, delta
    # one segment summary a layer, in the forward; the backward takes it
    assert delta["seg_summary_launches"] == delta["gdead_launches"] == 2
    dense = grads(towers["dense"])
    for n in ("wq", "wk", "wv"):
        key = f"page_tower.block0.attn.{n}.weight"
        rel = ((flash[key] - dense[key]).norm() / dense[key].norm()).item()
        assert flash[key].abs().max() > 0 and rel < 2e-2, (key, rel)
    again = grads(towers["flash"])
    for key, gf in flash.items():
        assert torch.equal(gf, again[key]), key


@pytest.mark.cuda
def test_cuda_flash_tower_gets_attention_gradients(cuda_device):
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    ov = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
          "model.mlp_dim": 128, "model.out_dim": 32, "model.dropout": 0.0}
    towers = {}
    for att in ("flash", "dense"):
        cfg = get_config("bert_mini_v5p16", {**ov, "model.attention": att})
        towers[att] = build_two_tower(cfg, vocab_size=256,
                                      device=cuda_device).train()
    towers["dense"].load_state_dict(towers["flash"].state_dict())
    ids = torch.randint(1, 256, (16, 64),
                        generator=torch.Generator().manual_seed(0))
    ids[:, 50:] = 0
    ids = ids.to(cuda_device)
    grads = {}
    for att, model in towers.items():
        before = (fa.launches, fa.dq_launches, fa.dkv_launches)
        model.encode_page(ids).square().sum().backward()
        after = (fa.launches, fa.dq_launches, fa.dkv_launches)
        if att == "flash":
            assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
        grads[att] = {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}
    for n in ("wq", "wk", "wv"):
        name = f"page_tower.block0.attn.{n}.weight"
        gf, gd = grads["flash"][name], grads["dense"][name]
        assert gf.abs().max() > 0, name
        rel = ((gf - gd).norm() / gd.norm()).item()
        assert rel < 2e-2, (name, rel)


@pytest.mark.cuda
def test_cuda_t5_tower_gets_bias_gradients_through_k4(cuda_device):
    """A t5 flash tower on the card: K1, K4 and K3 once per layer, no K2,
    and its gradients (the rel_bias table included) agree with the dense
    tower's at float32 and are bitwise equal from run to run."""
    from dnn_page_vectors_tpu_torch.config import get_config
    from dnn_page_vectors_tpu_torch.models.factory import build_two_tower
    ov = {"model.num_layers": 2, "model.model_dim": 64, "model.num_heads": 4,
          "model.mlp_dim": 128, "model.out_dim": 32, "model.dropout": 0.0,
          "model.dtype": "float32", "data.page_len": 48}
    towers = {}
    for att in ("flash", "dense"):
        cfg = get_config("mt5_multilingual", {**ov, "model.attention": att})
        towers[att] = build_two_tower(cfg, vocab_size=256,
                                      device=cuda_device).train()
    towers["dense"].load_state_dict(towers["flash"].state_dict())
    ids = torch.randint(1, 256, (16, 48),
                        generator=torch.Generator().manual_seed(0))
    ids[:, 40:] = 0
    ids[-1] = 0                          # a fully masked row
    ids = ids.to(cuda_device)

    def grads(model):
        model.zero_grad(set_to_none=True)
        model.encode_page(ids).square().sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    before = (fa.launches, fa.dq_launches, fa.dkv_launches,
              fa.dq_dbias_launches)
    flash = grads(towers["flash"])
    after = (fa.launches, fa.dq_launches, fa.dkv_launches,
             fa.dq_dbias_launches)
    assert [a - b for a, b in zip(after, before)] == [2, 0, 2, 2]
    dense = grads(towers["dense"])
    assert flash.keys() == dense.keys()
    assert flash["page_tower.rel_bias"].abs().max() > 0
    for name, gf in flash.items():
        torch.testing.assert_close(gf, dense[name], msg=name, rtol=1e-4,
                                   atol=1e-5)
    again = grads(towers["flash"])
    for name, gf in flash.items():
        assert torch.equal(gf, again[name]), name


# The bf16 tensor-core kernels (K1 and K3) at the edges of their tiling:
# head dims below 64 and not multiples of 16, 128; the query tile of L=16;
# one query row, one key; ragged L and S (S = 53 is not a multiple of 4, so
# the bias is staged in 4-byte pieces); the towers' strided views; a view
# that is not 16-byte aligned (the wrapper copies it). Every case has a
# batch row that sees no key.
TC_CASES = {
    "dh8": dict(Dh=8),
    "dh24": dict(Dh=24, bias=True),
    "dh40": dict(Dh=40),
    "dh128": dict(L=130, S=200, Dh=128, bias=True),
    "query_tile_L16": dict(B=8, H=4, L=16, S=16, pad_tail=3),
    "query_tile_L16_bias": dict(B=8, H=4, L=16, S=16, pad_tail=3, bias=True),
    "L1": dict(L=1, S=64),
    "S1": dict(L=64, S=1, pad_tail=0),
    "ragged_L37_S53": dict(L=37, S=53, pad_tail=7),
    "ragged_L37_S53_bias": dict(L=37, S=53, pad_tail=7, bias=True),
    "strided_L64": dict(B=8, H=4, L=64, S=64, strided=True),
    "strided_L128_bias": dict(B=4, H=12, L=128, S=128, strided=True,
                              bias=True),
    "unaligned": dict(L=37, S=53, pad_tail=7, unaligned=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_flash_fwd_matches_plain_version(cuda_device, case):
    x = _inputs(cuda_device, dtype=torch.bfloat16, **TC_CASES[case])
    before = (fa.launches_tc, fa.launches_f32)
    out, lse = fa.flash_forward(**x)
    torch.cuda.synchronize()
    assert (fa.launches_tc, fa.launches_f32) == (before[0] + 1, before[1])
    want_out, want_lse = fa.reference_forward(**x)
    tol = TOL[torch.bfloat16]
    assert out.shape == want_out.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, want_out, rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    mean_v = x["v"][-1].float().mean(dim=1, keepdim=True)
    torch.testing.assert_close(out[-1], mean_v.expand_as(out[-1]),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_tensor_core_flash_fwd_with_seg(cuda_device):
    x = _inputs(cuda_device, L=40, S=40, pad_tail=6, seg=True,
                dtype=torch.bfloat16)
    before = fa.launches_tc
    out, lse = fa.flash_forward(**x)
    torch.cuda.synchronize()
    assert fa.launches_tc == before + 1
    want_out, want_lse = fa.reference_forward(**x)
    torch.testing.assert_close(out, want_out, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_dkv_kernel_matches_plain_version(cuda_device, case):
    """The backward (K2 + K3, or K4 + K3 with a bias) in bf16: dk and dv
    come from the tensor-core K3."""
    c = TC_CASES[case]
    x, g, out, lse = _backward_inputs(cuda_device, dtype=torch.bfloat16, **c)
    q, k, v, mask, bias = x["q"], x["k"], x["v"], x["kv_mask"], x["bias"]
    before = (fa.dkv_launches_tc, fa.dkv_launches_f32)
    got = fa.flash_backward(q, k, v, mask, g, out, lse, bias)
    torch.cuda.synchronize()
    assert (fa.dkv_launches_tc, fa.dkv_launches_f32) == (before[0] + 1,
                                                         before[1])
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    names = ("dq", "dk", "dv", "dbias")[:3 if bias is None else 4]
    for name, a, b, t in zip(names, got, want, (q, k, v, bias)):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), msg=name,
                                   **GRAD_TOL[torch.bfloat16])
    # the last batch row sees no key: dv = sum_l g / S, and no dk
    S = k.shape[2]
    want_dv = (g[-1].float().sum(dim=1, keepdim=True) / S).expand_as(v[-1])
    torch.testing.assert_close(got[2][-1].float(), want_dv,
                               **GRAD_TOL[torch.bfloat16])
    assert not got[1][-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_tensor_core_dkv_kernel_is_bitwise_deterministic(cuda_device, bias):
    x, g, out, lse = _backward_inputs(cuda_device, B=16, H=12, L=128, S=128,
                                      dtype=torch.bfloat16, strided=True,
                                      bias=bias)
    q, k, v, mask = x["q"], x["k"], x["v"], x["kv_mask"]
    if bias:
        _, delta, _ = fa.launch_dq_dbias(q, k, v, mask, x["bias"], g, out,
                                         lse)
    else:
        _, delta = fa.launch_dq(q, k, v, mask, g, out, lse)
    first = fa.launch_dkv(q, k, v, mask, g, lse, delta, x["bias"])
    for _ in range(3):
        again = fa.launch_dkv(q, k, v, mask, g, lse, delta, x["bias"])
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k1_and_k3_dispatch_by_dtype(cuda_device, dtype):
    """bf16 q/k/v launch the tensor-core K1 and K3, f32 the CUDA-core
    ones; K2 serves both."""
    x = _inputs(cuda_device, dtype=dtype)
    for n in ("q", "k", "v"):
        x[n].requires_grad_(True)
    counts = lambda: (fa.launches_tc, fa.launches_f32, fa.dkv_launches_tc,
                      fa.dkv_launches_f32, fa.dq_launches)
    before = counts()
    out = fa.flash_attention(**x)
    out.sum().backward()
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(counts(), before)]
    want = [1, 0, 1, 0, 1] if dtype == torch.bfloat16 else [0, 1, 0, 1, 1]
    assert delta == want


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["uint8", "float", "strided_bool"])
def test_k1_and_k3_take_any_mask_form(cuda_device, form):
    """The wrappers pass a contiguous bool mask to the kernels as its bytes
    and convert any other one: a uint8, a float or a strided bool mask
    gives K1's and K3's results for the bool mask, bit for bit."""
    x = _inputs(cuda_device, B=4, L=37, S=53, pad_tail=7,
                dtype=torch.bfloat16, bias=True)
    mask = x["kv_mask"]
    if form == "uint8":
        other = mask.to(torch.uint8)
    elif form == "float":
        other = mask.float()
    else:        # every other column of a [B, 2S] bool tensor
        other = torch.zeros(mask.shape[0], 2 * mask.shape[1],
                            dtype=torch.bool, device=cuda_device)
        other[:, ::2] = mask
        other = other[:, ::2]
        assert not other.is_contiguous()
    with torch.no_grad():
        want = fa.flash_forward(**x)
        got = fa.flash_forward(**{**x, "kv_mask": other})
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    out, lse = want
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    _, delta, _ = fa.launch_dq_dbias(x["q"], x["k"], x["v"], mask, x["bias"],
                                     g, out, lse)
    dkv = [fa.launch_dkv(x["q"], x["k"], x["v"], m, g, lse, delta, x["bias"])
           for m in (mask, other)]
    for a, b in zip(*dkv):
        assert torch.equal(a, b)


# K2 and K4 on the tensor cores: the cases above, plus a batch that is not a
# multiple of K4's group of 8
TC_DQ_CASES = {**TC_CASES,
               "odd_batch_bias": dict(B=11, L=37, S=53, pad_tail=7,
                                      bias=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TC_DQ_CASES))
def test_tensor_core_dq_kernels_match_plain_version(cuda_device, case):
    """The bf16 K2 (dq, delta), or K4 (dq, delta, dbias) with a bias,
    alone against the plain backward; the batch row that sees no key adds
    nothing to dq or dbias."""
    c = TC_DQ_CASES[case]
    x, g, out, lse = _backward_inputs(cuda_device, dtype=torch.bfloat16, **c)
    q, k, v, mask, bias = x["q"], x["k"], x["v"], x["kv_mask"], x["bias"]
    counts = lambda: (fa.dq_launches_tc, fa.dq_launches_f32,
                      fa.dq_dbias_launches_tc, fa.dq_dbias_launches_f32)
    before = counts()
    if bias is None:
        dq, delta = fa.launch_dq(q, k, v, mask, g, out, lse)
        want_counts = [1, 0, 0, 0]
    else:
        dq, delta, dbias = fa.launch_dq_dbias(q, k, v, mask, bias, g, out,
                                              lse)
        want_counts = [0, 0, 1, 0]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == want_counts
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    assert dq.dtype == q.dtype and dq.shape == q.shape
    assert torch.isfinite(dq).all()
    torch.testing.assert_close(dq.float(), want[0].float(),
                               **GRAD_TOL[torch.bfloat16])
    torch.testing.assert_close(delta, (g.float() * out).sum(-1), rtol=1e-5,
                               atol=1e-5)
    assert not dq[-1].any()
    if bias is not None:
        torch.testing.assert_close(dbias, want[3], **GRAD_TOL[torch.bfloat16])
        rest = fa.reference_backward(q[:-1], k[:-1], v[:-1], mask[:-1],
                                     g[:-1], out[:-1], lse[:-1], bias)[3]
        torch.testing.assert_close(dbias, rest, **GRAD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["k2", "k4"])
def test_tensor_core_dq_kernels_are_bitwise_deterministic(cuda_device, bias):
    x, g, out, lse = _backward_inputs(cuda_device, B=19, H=12, L=128, S=128,
                                      dtype=torch.bfloat16, strided=True,
                                      bias=bias)
    q, k, v, mask = x["q"], x["k"], x["v"], x["kv_mask"]
    if bias:
        run = lambda: fa.launch_dq_dbias(q, k, v, mask, x["bias"], g, out,
                                         lse)
    else:
        run = lambda: fa.launch_dq(q, k, v, mask, g, out, lse)
    first = run()
    for _ in range(3):
        for a, b in zip(first, run()):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k2_and_k4_dispatch_by_dtype(cuda_device, dtype):
    """bf16 q/k/v launch the tensor-core K2 (no bias) and K4 (bias), f32
    the CUDA-core ones; the totals count both."""
    counts = lambda: (fa.dq_launches_tc, fa.dq_launches_f32,
                      fa.dq_dbias_launches_tc, fa.dq_dbias_launches_f32,
                      fa.dq_launches, fa.dq_dbias_launches)
    before = counts()
    for bias in (False, True):
        x = _inputs(cuda_device, dtype=dtype, bias=bias)
        for n in ("q", "k", "v"):
            x[n].requires_grad_(True)
        fa.flash_attention(**x).sum().backward()
    torch.cuda.synchronize()
    delta = [a - b for a, b in zip(counts(), before)]
    want = ([1, 0, 1, 0, 1, 1] if dtype == torch.bfloat16
            else [0, 1, 0, 1, 1, 1])
    assert delta == want


@pytest.mark.cuda
def test_k4_over_max_keys_runs_the_f32_kernel(cuda_device):
    """A bf16 K4 over more keys than its bias tile and partial hold in
    shared memory runs the f32 K4 on f32 copies; dq comes back in bf16,
    laid out like q."""
    S = fa.MAX_TC_DBIAS_KEYS + 8
    x, g, out, lse = _backward_inputs(cuda_device, B=3, H=2, L=24, S=S,
                                      dtype=torch.bfloat16, strided=True,
                                      bias=True)
    q, k, v, mask, bias = x["q"], x["k"], x["v"], x["kv_mask"], x["bias"]
    before = (fa.dq_dbias_launches_tc, fa.dq_dbias_launches_f32)
    dq, _, dbias = fa.launch_dq_dbias(q, k, v, mask, bias, g, out, lse)
    torch.cuda.synchronize()
    assert (fa.dq_dbias_launches_tc, fa.dq_dbias_launches_f32) == (
        before[0], before[1] + 1)
    want = fa.reference_backward(q, k, v, mask, g, out, lse, bias)
    assert dq.dtype == torch.bfloat16 and dq.stride() == q.stride()
    torch.testing.assert_close(dq.float(), want[0].float(),
                               **GRAD_TOL[torch.bfloat16])
    torch.testing.assert_close(dbias, want[3], **GRAD_TOL[torch.bfloat16])
