"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its kernel's plain version, so these tests
hold the plain versions (what the CUDA kernels are held against on the
card) against the Pallas kernels in interpret mode, the XLA flash path
and the naive oracle, on the same numpy inputs.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.attention import causal_flash_xla
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import flash_attention_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bf16 outputs: one bf16 ulp is 2^-8 relative, and the two sides round p
# to bf16 after maxima taken in another summation order, so a few ulps
# at |out| <= ~2 (rows average v ~ N(0, 1)).
BF16_ATOL = 3e-2


def _qkv(B, H, Hkv, Sq, Skv, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(dtype)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(dtype)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(dtype)
    return q, k, v


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("S,Hkv", [(128, 2), (192, 1), (64, 4)])
def test_flash_plain_matches_pallas_kernel_and_probe(S, Hkv):
    """Pallas kernel in interpret mode at the port's 64x64 blocks: bf16
    inputs, outputs within a few bf16 ulps (the Pallas kernel keeps p in
    f32, the port rounds it to bf16 as the XLA path does) and the probe
    counts of blocks visited / computed equal as integers."""
    q, k, v = _qkv(1, 4, Hkv, S, S, 64, seed=S + Hkv)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    o_j, probe_j = jax_flash(jb(q), jb(k), jb(v), causal=True,
                             block_q=fa.BLOCK_Q, block_k=fa.BLOCK_K,
                             with_probe=True, interpret=True)
    o_t, probe_t = fa.flash_attention(_t(q, torch.bfloat16),
                                      _t(k, torch.bfloat16),
                                      _t(v, torch.bfloat16), with_probe=True)
    np.testing.assert_array_equal(probe_t.numpy(), np.asarray(probe_j))
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), atol=BF16_ATOL)


@pytest.mark.parametrize("S", [64, 160])
def test_flash_plain_matches_xla_flash_and_ref(S):
    """f32 inputs: the XLA flash path at the same 64-key blocks makes the
    same bf16 roundings, so only f32 summation order separates the two,
    and where that flips the bf16 rounding of a p the row moves by up to
    2^-8 * (p / l) * |v| (atol 5e-3, |v| < 5). The naive oracle
    keeps everything in f32: bf16 rounding of q, k, p, v then dominates
    (atol 3e-2)."""
    q, k, v = _qkv(2, 4, 2, S, S, 16, seed=S)
    o_t = fa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    kr = np.repeat(k, 2, axis=1)
    vr = np.repeat(v, 2, axis=1)
    o_x = causal_flash_xla(tr(q), tr(kr), tr(vr), 64, 64)
    np.testing.assert_allclose(o_t, np.asarray(o_x).transpose(0, 2, 1, 3),
                               atol=5e-3)
    o_r = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    np.testing.assert_allclose(o_t, o_r, atol=3e-2)
    np.testing.assert_allclose(
        flash_attention_ref(_t(q), _t(k), _t(v)).numpy(), o_r, atol=1e-5)


@pytest.mark.parametrize("q_offset,Sq", [(96, 64), (80, 16), (0, 40)])
def test_flash_offset_rows_equal_whole_call(q_offset, Sq):
    """Rows taken at an offset against the whole context equal the same
    rows of the whole call bit for bit: each row walks the same kv blocks
    whatever its q tile (the chunked-prefill contract)."""
    q, k, v = _qkv(1, 4, 2, 160, 160, 16, seed=3)
    whole, probe = fa.flash_attention(_t(q), _t(k), _t(v), with_probe=True)
    part = fa.flash_attention(_t(q[:, :, q_offset:q_offset + Sq]), _t(k),
                              _t(v), q_offset=q_offset)
    assert torch.equal(part, whole[:, :, q_offset:q_offset + Sq])
    assert probe[0, 0].tolist() == [[3, 1], [3, 2], [3, 3]]


def test_flash_wrapper_checks_shapes():
    q, k, v = (_t(x) for x in _qkv(1, 4, 3, 8, 8, 16, seed=0))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)
    q, k, v = (_t(x) for x in _qkv(1, 4, 2, 8, 8, 16, seed=0))
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention(q, k, v, q_offset=4)


def _paged_inputs(seed=3):
    # the shapes of tests/test_engine.py::test_paged_attention_kernel_matches_dense
    B, KV, G, HD, PS, NP, POOL = 3, 2, 2, 8, 4, 4, 16
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, HD)).astype(np.float32)
    pk = rng.standard_normal((POOL, PS, KV, HD)).astype(np.float32)
    pv = rng.standard_normal((POOL, PS, KV, HD)).astype(np.float32)
    pages = rng.permutation(POOL)[:B * NP].reshape(B, NP).astype(np.int32)
    pos = np.array([0, 7, 15], np.int32)
    return q, pk, pv, pages, pos


def test_paged_plain_matches_pallas_kernel():
    """Same global softmax on bf16 pools: equal up to f32 summation order
    (and the rare bf16 flip of p / l): atol 1e-5 at |out| <~ 2."""
    q, pk, pv, pages, pos = _paged_inputs()
    ref = jax_paged(jnp.asarray(q), jnp.asarray(pk, jnp.bfloat16),
                    jnp.asarray(pv, jnp.bfloat16), jnp.asarray(pages),
                    jnp.asarray(pos), interpret=True)
    out = pa.paged_attention(_t(q), _t(pk, torch.bfloat16),
                             _t(pv, torch.bfloat16),
                             torch.from_numpy(pages), torch.from_numpy(pos))
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_paged_wrapper_checks_pages_per_step():
    q, pk, pv, pages, pos = _paged_inputs()
    args = (_t(q), _t(pk), _t(pv), torch.from_numpy(pages),
            torch.from_numpy(pos))
    pa.paged_attention(*args, pages_per_step=2)
    with pytest.raises(ValueError, match="pages_per_step"):
        pa.paged_attention(*args, pages_per_step=3)


def test_cpu_tensors_take_plain_path_without_counting():
    q, k, v = (_t(x) for x in _qkv(1, 2, 1, 8, 8, 16, seed=1))
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_plain(q, k, v))
    q, pk, pv, pages, pos = _paged_inputs()
    args = (_t(q), _t(pk), _t(pv), torch.from_numpy(pages),
            torch.from_numpy(pos))
    assert torch.equal(pa.paged_attention(*args),
                       pa.paged_attention_plain(*args))
    assert fa.flash_attention.launches == 0
    assert pa.paged_attention.launches == 0


def test_kernel_modules_import_without_nvcc_or_triton():
    """Importing builds nothing and needs neither nvcc nor triton (run
    with PATH emptied so no nvcc can be found)."""
    code = (
        "import sys\n"
        "import repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.paged_attention, repro_torch.kernels.ref\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS\n"
        "assert 'triton' not in sys.modules\n")
    env = {"PYTHONPATH": "src", "PATH": ""}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO)



# ------------------------------------------------------------- tiles
# the DSE's tile axes: the plain version at each (block_q, block_k) walks
# the kernel's kv blocks of that size, held against the Pallas kernel in
# interpret mode at the same blocks; the paged plain version at each
# tile_slots (its global softmax does not depend on the tile) against
# JAX's paged kernel, its counter block against ``slot_counts``

@pytest.mark.parametrize("block_q,block_k",
                         [(bq, bk) for bq in fa.BLOCKS_Q for bk in fa.BLOCKS_K])
def test_flash_plain_at_each_tile_matches_pallas_at_the_same_blocks(
        block_q, block_k):
    """bf16 inputs, outputs within a few bf16 ulps (as at the default
    tiles), the probe counts of kv blocks visited / computed per q tile
    equal as integers, and rows at a q offset equal the whole call's."""
    S = 256
    q, k, v = _qkv(1, 2, 1, S, S, 32, seed=block_q + block_k)
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    o_j, probe_j = jax_flash(jb(q), jb(k), jb(v), causal=True,
                             block_q=block_q, block_k=block_k,
                             with_probe=True, interpret=True)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    o_t, probe_t = fa.flash_attention(tq, tk, tv, with_probe=True,
                                      block_q=block_q, block_k=block_k)
    np.testing.assert_array_equal(probe_t.numpy(), np.asarray(probe_j))
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), atol=BF16_ATOL)
    part = fa.flash_attention(tq[:, :, 100:180].contiguous(), tk, tv,
                              q_offset=100, block_q=block_q, block_k=block_k)
    assert torch.equal(part, o_t[:, :, 100:180])


def test_flash_tiles_are_checked():
    q, k, v = (_t(x) for x in _qkv(1, 2, 1, 8, 8, 16, seed=0))
    with pytest.raises(ValueError, match="tiles"):
        fa.flash_attention(q, k, v, block_q=32)
    with pytest.raises(ValueError, match="tiles"):
        fa.flash_attention(q, k, v, block_k=256)


@pytest.mark.parametrize("tile_slots", pa.TILES)
def test_paged_plain_at_each_tile_matches_pallas_kernel(tile_slots):
    q, pk, pv, pages, pos = _paged_inputs()
    ref = jax_paged(jnp.asarray(q), jnp.asarray(pk, jnp.bfloat16),
                    jnp.asarray(pv, jnp.bfloat16), jnp.asarray(pages),
                    jnp.asarray(pos), interpret=True)
    args = (_t(q), _t(pk, torch.bfloat16), _t(pv, torch.bfloat16),
            torch.from_numpy(pages), torch.from_numpy(pos))
    out = pa.paged_attention(*args, tile_slots=tile_slots)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    _, counts = pa.paged_attention_plain(*args, with_counts=True,
                                         tile_slots=tile_slots)
    want = pa.slot_counts(pos, pages.shape[1], pk.shape[1], q.shape[1],
                          tile_slots)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert counts.shape[2] == -(-pages.shape[1] * pk.shape[1] // tile_slots)
    with pytest.raises(ValueError, match="tile_slots"):
        pa.paged_attention(*args, tile_slots=48)


def test_declared_shared_memory_follows_the_sources_formulas():
    """The budget's view of each tile: flash at head dim 128 with kv
    blocks of 128 keys needs more dynamic shared memory than a block may
    have (both q tiles), all six fit at head dim 64; paged at head dim
    128, 16 rows and 128-slot tiles is over the static 48 KB."""
    from repro_torch.core.costmodel import DeviceBudget
    budget = DeviceBudget()
    over = [(D, bq, bk) for D in fa.HEAD_DIMS for bq in fa.BLOCKS_Q
            for bk in fa.BLOCKS_K
            if budget.violations(fa.flash_resources(D, bq, bk))]
    assert over == [(128, 64, 128), (128, 128, 128)]
    assert fa.flash_smem_bytes(128, 64, 128) == 295936
    assert fa.flash_smem_bytes(128, 128, 128) == 313344
    assert fa.flash_smem_bytes(64, 64, 64) == 82944
    assert fa.flash_smem_bytes(64, 128, 128) == 165888
    over = [(hd, g, ts) for hd in pa.HEAD_DIMS for g in (8, 16)
            for ts in pa.TILES
            if budget.violations(pa.paged_resources(hd, g, ts))]
    assert over == [(128, 16, 128)]
