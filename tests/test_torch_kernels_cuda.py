"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are the JAX flash tests': 2e-5 for float32, 2e-2 for bfloat16
(the plain version rounds probabilities to bf16 before the product with V,
the kernel does not)."""
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
            pad_tail=5, bias=False, seg=False, strided=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    if strided:      # [B, L, H, Dh] viewed as [B, H, L, Dh], as the towers do
        q, k, v = (torch.randn(B, n, H, Dh, generator=g).transpose(1, 2)
                   for n in (L, S, S))
    else:
        q, k, v = (torch.randn(B, H, n, Dh, generator=g) for n in (L, S, S))
    mask = torch.ones(B, S, dtype=torch.bool)
    if pad_tail:
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
