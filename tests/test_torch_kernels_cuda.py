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
and 2e-2 in bfloat16."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("extra", ["seg"])
def test_flash_backward_with_bias_or_seg_is_not_ported(cuda_device, extra):
    x = _inputs(cuda_device, L=40, S=40, pad_tail=6, seg=True)
    for n in ("q", "k", "v"):
        x[n].requires_grad_(True)
    out = fa.flash_attention(**x)          # the forward takes seg
    with pytest.raises(NotImplementedError, match="slice 4"):
        out.sum().backward()


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
