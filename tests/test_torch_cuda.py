"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the serving path does not reach (ragged tiles, q offsets off
the block grid, head dim 128, non-causal, the paged kernel's global
score scratch). Every test needs an NVIDIA GPU and nvcc and skips
without them. On the card, with no JAX installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.cuda

# bf16 outputs of |x| <~ 3: a few bf16 ulps (see chip_smoke.py)
FLASH_ATOL = 3e-2
PAGED_ATOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bf16(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,q_offset,causal", [
    (2, 4, 2, 100, 300, 128, 200, True),
    (1, 8, 8, 70, 130, 64, 0, False),
    (3, 6, 3, 1, 65, 64, 64, True),
])
def test_flash_kernel_matches_plain(dev, B, H, Hkv, Sq, Skv, D, q_offset,
                                    causal):
    gen = torch.Generator(device=dev).manual_seed(Sq)
    q = _bf16((B, H, Sq, D), gen, dev)
    k, v = _bf16((B, Hkv, Skv, D), gen, dev), _bf16((B, Hkv, Skv, D), gen, dev)
    out, probe = fa.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset, with_probe=True)
    ref, probe_ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                              q_offset=q_offset,
                                              with_probe=True)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL
    assert torch.equal(probe, probe_ref)


def test_flash_kernel_offset_rows_bitwise_off_grid(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _bf16((1, 4, 200, 64), gen, dev)
    k, v = _bf16((1, 1, 200, 64), gen, dev), _bf16((1, 1, 200, 64), gen, dev)
    whole = fa.flash_attention(q, k, v)
    for off, n in ((80, 50), (16, 16), (199, 1)):
        part = fa.flash_attention(q[:, :, off:off + n].contiguous(), k, v,
                                  q_offset=off)
        assert torch.equal(part, whole[:, :, off:off + n]), (off, n)


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("hd,n_pages", [(64, 34), (128, 520)])
def test_paged_kernel_matches_plain(dev, hd, n_pages):
    """(128, 520): 8 rows x 8320 slots of scores exceed shared memory, so
    the wrapper hands the kernel a global scratch."""
    B, kv, g, ps = 3, 2, 8, 16
    P = B * n_pages + 1
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = _bf16((B, kv, g, hd), gen, dev)
    pool_k, pool_v = _bf16((P, ps, kv, hd), gen, dev), _bf16((P, ps, kv, hd),
                                                             gen, dev)
    pages = (torch.randperm(P - 1, device=dev)[:B * n_pages] + 1).reshape(
        B, n_pages).to(torch.int32)
    pos = torch.tensor([0, ps * n_pages // 2, ps * n_pages - 1],
                       dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, pool_k, pool_v, pages, pos)
    ref = pa.paged_attention_plain(q, pool_k, pool_v, pages, pos)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= PAGED_ATOL
