"""The port's CUDA kernels against their plain versions, on the card.

Edge shapes the serving path does not reach (ragged tiles, q offsets off
the block grid, head dims 80 (zamba2's shared attention: a tile's copy
with a guarded last pass) and 128, non-causal, many double-buffered kv
blocks, one q row, H == Hkv; for the paged kernel: positions at
slot-tile boundaries, page sizes 8 and 32, groups of 1 and 16, long
rows, bitwise invariance to batching and page placement; for the SSD
scan: f32 inputs, N of 64, sub-chunks that are not a multiple of the
kernels' 64-row tile, one chunk and 16 chunks, one head a group and
partial head blocks, the zero-padded tail, strided b/c views aligned and
not, bitwise invariance to batching); the probe on the card, and a
streaming session over the engine's paged decode step, whose spilled
rows arrive through their copy events; the flash kernel's row
statistics (m, l) against the plain version's, and the training
backward from the kernel's forward against the same backward from the
plain forward, then through the ``autograd.Function`` with GQA; each
kernel's counter block for grid-step probing against its plain
version's, with outputs bitwise the launch's without it, the
``probe_grid`` fold against its plain version, and kernel-probed
programs of the three kernels (record == oracle, outputs bitwise,
offload); every flash (block_q, block_k) and paged tile_slots of the DSE
against its plain version at that tile (with its counter block, rows at
a q offset, batching), its declared shared memory against
``cudaFuncGetAttributes``', and the tiles the card cannot hold refused.
Every test needs an NVIDIA GPU and nvcc and skips without them. On the card, with no JAX installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_ref

pytestmark = pytest.mark.cuda

# bf16 outputs of |x| <~ 3: a few bf16 ulps (see chip_smoke.py)
FLASH_ATOL = 3e-2
PAGED_ATOL = 1e-3
# SSD scan, relative to max |value|: y rounded once to bf16 against an f32
# computation of the same bf16 inputs, one bf16 ulp; f32 y and the f32
# state, f32 summation order
SSD_BF16_RTOL = 8e-3
SSD_F32_RTOL = 1e-5


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
    (1, 4, 2, 4096, 4096, 128, 0, True),     # 64 double-buffered kv blocks
    (1, 4, 2, 256, 4096, 128, 3840, True),   # a chunk at the end of 4096
    (2, 8, 4, 1, 1000, 64, 999, True),       # one q row, ragged kv
    (2, 4, 4, 200, 200, 128, 0, True),       # H == Hkv
    (1, 8, 2, 37, 300, 64, 263, True),       # Sq not a multiple of 16
    (1, 2, 1, 150, 150, 64, 0, False),
    (2, 8, 8, 512, 512, 80, 0, True),        # zamba2: D 80, MHA
    (1, 4, 2, 70, 333, 80, 263, True),       # D 80, ragged, at an offset
    (1, 4, 1, 1, 97, 80, 96, True),          # D 80, one q row
    (1, 2, 2, 130, 130, 80, 0, False),
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


@pytest.mark.parametrize("D", [64, 80])
def test_flash_kernel_offset_rows_bitwise_off_grid(dev, D):
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _bf16((1, 4, 200, D), gen, dev)
    k, v = _bf16((1, 1, 200, D), gen, dev), _bf16((1, 1, 200, D), gen, dev)
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
    """(128, 520): rows of 8320 slots, 130 slot tiles each."""
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


def _paged_case(dev, B, kv, g, hd, ps, n_pages, pos, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    P = B * n_pages + 1
    q = _bf16((B, kv, g, hd), gen, dev)
    pool_k, pool_v = _bf16((P, ps, kv, hd), gen, dev), _bf16((P, ps, kv, hd),
                                                             gen, dev)
    pages = (torch.randperm(P - 1, generator=cpu)[:B * n_pages] + 1).reshape(
        B, n_pages).to(torch.int32).to(dev)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, pages, pos


@pytest.mark.parametrize("g,ps,n_pages", [
    (8, 16, 34),     # the serving shape
    (8, 8, 40),      # pages of 8
    (8, 32, 9),      # pages of 32
    (1, 16, 12),     # one query row per kv head
    (16, 16, 12),    # the largest group the kernel takes
])
def test_paged_kernel_tile_boundaries(dev, g, ps, n_pages):
    """pos at 0 and either side of each slot-tile boundary."""
    T = pa.TILE_SLOTS
    pos = [0, T - 1, T, T + 1, 2 * T - 1, 2 * T, ps * n_pages - 1, 1]
    args = _paged_case(dev, len(pos), 4, g, 64, ps, n_pages, pos, seed=g + ps)
    out = pa.paged_attention(*args)
    ref = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= PAGED_ATOL


@pytest.mark.parametrize("B", [1, 3, 8])
def test_paged_kernel_bitwise_invariant(dev, B):
    """Row b of a batch-B call equals the B=1 call on row b; moving the
    pages in the pool, or widening the page table past pos, changes no
    bit."""
    n_pages, ps = 34, 16
    pos = [543, 64, 127, 0, 300, 511, 65, 200][:B]
    q, pool_k, pool_v, pages, pos = _paged_case(dev, B, 4, 8, 64, ps,
                                                n_pages, pos, seed=B)
    out = pa.paged_attention(q, pool_k, pool_v, pages, pos)
    for b in range(B):
        one = pa.paged_attention(q[b:b + 1], pool_k, pool_v, pages[b:b + 1],
                                 pos[b:b + 1])
        assert torch.equal(one, out[b:b + 1]), b
    P = pool_k.shape[0]
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(B)).to(dev)
    moved_k, moved_v = torch.empty_like(pool_k), torch.empty_like(pool_v)
    moved_k[perm], moved_v[perm] = pool_k, pool_v
    moved = pa.paged_attention(q, moved_k, moved_v,
                               perm[pages.long()].to(torch.int32), pos)
    assert torch.equal(moved, out)
    wide = torch.cat([pages, pages[:, :6]], dim=1)     # 40 pages, same rows
    assert torch.equal(pa.paged_attention(q, pool_k, pool_v, wide, pos), out)


def _ssd_inputs(B, L, H, P, G, N, dtype, dev, seed):
    """dt log-uniform in [1e-3, 1e-1], A in [1, 16]: x = N(0,1) dt,
    a = -A dt (f32), b and c N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.exp(torch.empty((B, L, H), device=dev).uniform_(
        -6.9078, -2.3026, generator=gen))
    A = torch.empty((H,), device=dev).uniform_(1.0, 16.0, generator=gen)
    x = (torch.randn((B, L, H, P), generator=gen, device=dev)
         * dt[..., None]).to(dtype)
    b = torch.randn((B, L, G, N), generator=gen, device=dev).to(dtype)
    c = torch.randn((B, L, G, N), generator=gen, device=dev).to(dtype)
    return x, -A * dt, b, c


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ssd_vs_plain(dev, B, L, H, P, G, N, chunk, pipeline, dtype, seed):
    """The kernels against the plain version on f32 copies of the same
    inputs: y at one bf16 ulp (bf16) or f32 order (f32), the f32 state
    at f32 order."""
    x, a, b, c = _ssd_inputs(B, L, H, P, G, N, dtype, dev, seed=seed)
    y, s = ssd.ssd_scan(x, a, b, c, chunk=chunk, pipeline=pipeline,
                        h_per_g=H // G, return_final_state=True)
    py, ps = ssd.ssd_scan_plain(x.float(), a, b.float(), c.float(),
                                chunk=chunk, pipeline=pipeline,
                                h_per_g=H // G, return_final_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    tol = SSD_BF16_RTOL if dtype == torch.bfloat16 else SSD_F32_RTOL
    assert _rel(y, py) <= tol
    assert _rel(s, ps) <= SSD_F32_RTOL


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,pipeline,dtype", [
    (2, 384, 4, 64, 2, 128, 192, 2, torch.bfloat16),   # Q=96: ragged tile
    (1, 200, 2, 64, 1, 64, 200, 1, torch.bfloat16),    # Q=200, N=64
    (2, 256, 8, 64, 4, 64, 128, 1, torch.float32),     # f32, 4 groups
    (1, 64, 2, 64, 2, 128, 16, 1, torch.float32),      # Q=16 < one warp run
])
def test_ssd_kernel_matches_plain(dev, B, L, H, P, G, N, chunk, pipeline,
                                  dtype):
    _ssd_vs_plain(dev, B, L, H, P, G, N, chunk, pipeline, dtype, seed=L)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,pipeline,dtype", [
    (2, 256, 8, 64, 1, 128, 256, 1, torch.bfloat16),   # one chunk: L == Q
    (1, 4096, 4, 64, 1, 128, 256, 1, torch.bfloat16),  # 16 chunks
    (2, 256, 4, 64, 4, 64, 128, 1, torch.bfloat16),    # h_per_g = 1
    (2, 512, 6, 64, 2, 128, 256, 2, torch.bfloat16),   # 3 heads a group
    (1, 512, 6, 64, 1, 64, 256, 1, torch.bfloat16),    # head blocks 4 + 2
    (1, 512, 6, 64, 2, 128, 128, 1, torch.float32),    # f32, 3 heads a group
    (2, 1024, 32, 64, 1, 128, 256, 1, torch.bfloat16),  # the serving widths
])
def test_ssd_kernel_decomposition(dev, B, L, H, P, G, N, chunk, pipeline,
                                  dtype):
    """Chunk counts, head blocks and groups of the three-pass design."""
    _ssd_vs_plain(dev, B, L, H, P, G, N, chunk, pipeline, dtype, seed=L + H)


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_kernel_zero_padded_tail(dev, N):
    """S=300 padded to 512 with a=0, x=0 (as ``ssm_apply`` pads): the
    first S outputs and the state are the unpadded recurrence's."""
    B, S, H, P, G, chunk = 2, 300, 4, 64, 1, 256
    x, a, b, c = _ssd_inputs(B, S, H, P, G, N, torch.bfloat16, dev, seed=N)
    pad = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, 512 - S))
           for t in (x, a, b, c)]
    y, s = ssd.ssd_scan(*pad, chunk=chunk, h_per_g=H // G,
                        return_final_state=True)
    ry, rs = ssd_ref(x.permute(0, 2, 1, 3), a.permute(0, 2, 1),
                     b.permute(0, 2, 1, 3), c.permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    assert _rel(y[:, :S], ry.permute(0, 2, 1, 3)) <= SSD_BF16_RTOL
    assert _rel(s, rs) <= SSD_F32_RTOL


def test_ssd_kernel_strided_bf16_views_aligned_and_not(dev):
    """b and c as column views of one bf16 conv output: rows of 16-byte
    multiples run through the kernels; a row stride that is not raises
    ``ValueError`` and launches nothing (no fallback)."""
    B, L, H, P, G, N = 2, 256, 4, 64, 2, 128
    x, a, _, _ = _ssd_inputs(B, L, H, P, G, N, torch.bfloat16, dev, seed=9)
    for extra, aligned in ((8, True), (1, False)):
        bc = torch.randn((B, L, 2 * G * N + extra), device=dev).to(
            torch.bfloat16)
        b = bc[..., :G * N].reshape(B, L, G, N)
        c = bc[..., G * N:2 * G * N].reshape(B, L, G, N)
        before = ssd.ssd_scan.launches
        if not aligned:
            with pytest.raises(ValueError, match="16-byte aligned"):
                ssd.ssd_scan(x, a, b, c, chunk=128, h_per_g=H // G)
            assert ssd.ssd_scan.launches == before
            continue
        y, s = ssd.ssd_scan(x, a, b, c, chunk=128, h_per_g=H // G,
                            return_final_state=True)
        py, ps = ssd.ssd_scan_plain(x.float(), a, b.float(), c.float(),
                                    chunk=128, h_per_g=H // G,
                                    return_final_state=True)
        torch.cuda.synchronize()
        assert ssd.ssd_scan.launches == before + 1
        assert _rel(y, py) <= SSD_BF16_RTOL
        assert _rel(s, ps) <= SSD_F32_RTOL


@pytest.mark.parametrize("B", [1, 3, 8])
def test_ssd_kernel_bitwise_batch_invariant(dev, B):
    """Row b of a batch-B call equals the B=1 call on row b, y and the
    state, bit for bit."""
    H, P, G, N, L, chunk = 8, 64, 1, 128, 512, 256
    x, a, b, c = _ssd_inputs(B, L, H, P, G, N, torch.bfloat16, dev, seed=B)
    y, s = ssd.ssd_scan(x, a, b, c, chunk=chunk, h_per_g=H // G,
                        return_final_state=True)
    for i in range(B):
        yi, si = ssd.ssd_scan(x[i:i + 1], a[i:i + 1], b[i:i + 1],
                              c[i:i + 1], chunk=chunk, h_per_g=H // G,
                              return_final_state=True)
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(si, s[i:i + 1]), i


def test_ssd_kernel_matches_ref_on_strided_views(dev):
    """b and c as the column views of one conv output, as ``ssm_apply``
    hands them over; against the exact recurrence."""
    B, L, H, P, G, N = 2, 96, 4, 64, 2, 128
    x, a, _, _ = _ssd_inputs(B, L, H, P, G, N, torch.float32, dev, seed=5)
    bc = torch.randn((B, L, 2 * G * N + 8), device=dev)
    b = bc[..., :G * N].reshape(B, L, G, N)
    c = bc[..., G * N:2 * G * N].reshape(B, L, G, N)
    y, s = ssd.ssd_scan(x, a, b, c, chunk=32, h_per_g=H // G,
                        return_final_state=True)
    ry, rs = ssd_ref(x.permute(0, 2, 1, 3), a.permute(0, 2, 1),
                     b.permute(0, 2, 1, 3), c.permute(0, 2, 1, 3))
    torch.cuda.synchronize()
    assert _rel(y, ry.permute(0, 2, 1, 3)) <= SSD_F32_RTOL
    assert _rel(s, rs) <= SSD_F32_RTOL


def test_ssd_kernel_rejects_what_it_does_not_take(dev):
    x, a, b, c = _ssd_inputs(1, 32, 2, 16, 1, 128, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match="head dim"):
        ssd.ssd_scan(x, a, b, c, chunk=32, h_per_g=2)
    x, a, b, c = _ssd_inputs(1, 32, 2, 64, 1, 16, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match="state dim"):
        ssd.ssd_scan(x, a, b, c, chunk=32, h_per_g=2)
    x, a, b, c = _ssd_inputs(1, 32, 2, 64, 1, 64, torch.float16, dev, 0)
    with pytest.raises(ValueError, match="share one of"):
        ssd.ssd_scan(x, a, b, c, chunk=32, h_per_g=2)
    x, a, b, c = _ssd_inputs(1, 32, 2, 64, 1, 64, torch.bfloat16, dev, 0)
    with pytest.raises(ValueError, match="a must be"):
        ssd.ssd_scan(x, a.to(torch.bfloat16), b, c, chunk=32, h_per_g=2)
    with pytest.raises(ValueError, match="different devices"):
        ssd.ssd_scan(x, a.cpu(), b, c, chunk=32, h_per_g=2)


# ------------------------------------------------------------ probe core

def _random_transitions(seed, n, steps):
    """(codes, seg) per transition: exits of open probes, then enters of
    closed ones, as the instrumented run issues them."""
    import random
    from repro_torch.kernels import probe_events as kpe
    rnd = random.Random(seed)
    spill = [i % 2 == 1 for i in range(n)]
    open_, out = set(), []
    for _ in range(steps):
        exits = sorted(p for p in open_ if rnd.random() < 0.5)
        enters = sorted(p for p in set(range(n)) - open_ - set(exits)
                        if rnd.random() < 0.5)
        open_ = (open_ - set(exits)) | set(enters)
        out.append(([kpe.encode(p, False, spill[p]) for p in exits]
                    + [kpe.encode(p, True, spill[p]) for p in enters],
                    rnd.randrange(1 << 40)))
    return out


@pytest.mark.parametrize("n,depth", [(1, 1), (5, 3), (40, 4)])
def test_probe_events_kernel_matches_plain(dev, n, depth):
    """Model clock: the kernel and its plain version give the same int64
    state after a sequence of transitions (spilling and not)."""
    from repro_torch.core import init_state
    from repro_torch.kernels import probe_events as kpe
    ks, ps = init_state(n, depth, dev), init_state(n, depth, dev)
    for codes, seg in _random_transitions(n, n, 80):
        kpe.probe_events(ks, codes, seg)
        kpe.probe_events_plain(ps, codes, seg)
    for k in ks:
        assert torch.equal(ks[k], ps[k]), k


def test_probe_events_wallclock_is_monotone(dev):
    """%globaltimer read in stream order: each enter's time <= its exit's,
    and the clock never goes back."""
    from repro_torch.core import decode_record, init_state
    from repro_torch.kernels import probe_events as kpe
    st = init_state(1, 8, dev)
    last = 0
    for _ in range(8):
        kpe.probe_events(st, [kpe.encode(0, True, False)], wallclock=True)
        torch.cuda._sleep(10000)
        kpe.probe_events(st, [kpe.encode(0, False, False)], wallclock=True)
        rec = decode_record(st)
        assert rec["cycle"] >= last > -1
        last = rec["cycle"]
    ring = rec["ring"][0]
    assert (ring[:, 0] <= ring[:, 1]).all() and (ring[1:, 0] >= ring[:-1, 1]).all()
    assert rec["totals"][0] == int((ring[:, 1] - ring[:, 0]).sum())


def test_probe_on_the_card_equals_oracle(dev):
    """A probed program with a scan, a branch and the flash kernel on
    CUDA tensors: record == oracle, outputs bitwise, one flash launch a
    call inside the probed run."""
    from repro_torch.core import ProbeConfig, decode_record, probe, scope

    def fn(q, k, v, w):
        with scope.named_scope("layers"):
            for _ in scope.scan(3):
                with scope.named_scope("attn"):
                    q = fa.flash_attention(q, k, v) + q
                with scope.named_scope("mix"):
                    q = (q.float() @ w).to(q.dtype)
        with scope.named_scope("head"):
            return scope.cond(q.float().sum() > 0, lambda t: t * 2,
                              lambda t: t - 1, q)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((1, 8, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    w = torch.randn((64, 64), generator=gen, device=dev) / 8
    for offload in (0.0, 0.5):
        pf = probe(fn, ProbeConfig(inline="off_all", offload=offload,
                                   buffer_depth=2))
        pf.ensure_built(q, k, v, w)
        fa.flash_attention.launches = 0
        out, rec = pf(q, k, v, w)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == 3
        assert torch.equal(out, fn(q, k, v, w))
        oc = pf.oracle(q, k, v, w)
        dec = decode_record(rec)
        assert dec["cycle"] == oc.cycle
        for key in ("starts", "ends", "totals", "calls"):
            assert [int(x) for x in dec[key]] == getattr(oc, key), key
        rows = pf.report(rec).rows
        for i, row in enumerate(rows):        # spilled rows reassembled
            if pf.assignment.spill[i]:
                assert row.iters == oc.history[i], row.path
        assert (pf.sink.dumps > 0) == (offload > 0)


def test_session_over_the_engine_decode_on_the_card(dev):
    """A small-width tinyllama (head dim 64, so the paged kernel takes
    it) decoded by the engine's paged decode step, 12 steps under a
    ProbeSession with every probe spilling at ring depth 4: outputs and
    pools bitwise equal to the unprobed step's on twin pools, the rows
    arrive through their CUDA events (none dropped), the duration stats
    cover every call, and the host's copies of the calls and the clock
    equal the device's."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import ProbeConfig, ProbeSession, decode_record
    from repro_torch.engine import build_paged_decode
    from repro_torch.models import Model
    cfg = smoke_config("tinyllama-1.1b").replace(
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64)
    m = Model(cfg)
    p = m._compute_cast(m.init(0, dev))
    B, n_pages, ps, P = 4, 4, 16, 24
    shape = (cfg.num_layers, P, ps, cfg.num_kv_heads, 64)
    gen = torch.Generator(device=dev).manual_seed(3)
    pools = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2)]
    twins = [t.clone() for t in pools]
    step = build_paged_decode(m, B, n_pages, ps, use_kernel=True)
    pages = torch.arange(1, 1 + B * n_pages, device=dev,
                         dtype=torch.int32).reshape(B, n_pages)
    toks = torch.randint(0, 257, (B, 1), device=dev, dtype=torch.int32,
                         generator=gen)
    s = ProbeSession(step, ProbeConfig(offload=1.0, buffer_depth=4),
                     window_steps=4, device=dev)
    for i in range(12):
        batch = {"tokens": toks, "pages": pages,
                 "pos": torch.full((B,), 20 + i, device=dev,
                                   dtype=torch.int32)}
        got = s.step(p, pools[0], pools[1], batch)
        want = step(p, twins[0], twins[1], batch)
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        toks = got[3][:, None]
    assert all(torch.equal(a, b) for a, b in zip(pools, twins))
    snap = s.snapshot()
    dec = decode_record(s._state)
    assert [int(c) for c in dec["calls"]] == s._calls
    assert dec["cycle"] == s.clock() == snap.span
    assert s.sink.dumps > 0 and s.sink.dropped == 0
    for r in snap.rows:
        assert r.observed == r.calls > 0, r.path
    s.close()


# row statistics: m a maximum of f32 scores taken in log2 units and scaled
# back (a few f32 ulps), l a sum of exp terms in another order with the
# MUFU exp2 (a few ulps each)
STATS_M_ATOL, STATS_L_RTOL = 1e-4, 1e-4


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (2, 8, 2, 1024, 64), (1, 4, 4, 300, 128), (2, 4, 1, 65, 64),
    (1, 4, 4, 200, 80)])
def test_flash_kernel_row_statistics_match_plain(dev, B, H, Hkv, S, D):
    gen = torch.Generator(device=dev).manual_seed(B * S + D)
    q, k, v = (_bf16(shape, gen, dev) for shape in
               ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, m, l = fa.flash_attention(q, k, v, with_stats=True)
    po, pm, pl = fa.flash_attention_plain(q, k, v, with_stats=True)
    assert torch.equal(out, fa.flash_attention(q, k, v))
    assert (out.float() - po.float()).abs().max().item() <= FLASH_ATOL
    assert (m - pm).abs().max().item() <= STATS_M_ATOL
    assert ((l - pl).abs() / pl).max().item() <= STATS_L_RTOL


# bf16 grads from two forwards whose outputs and statistics are a few
# ulps apart: a few bf16 ulps (2^-8 relative) of the largest |grad| (see
# chip_smoke.py)
BWD_RTOL = 2e-2


def test_flash_backward_from_the_kernel_forward_matches_plain(dev):
    from repro_torch.models import attention as attn
    B, H, Hkv, S, D = 2, 8, 2, 512, 64
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, dout = (_bf16(shape, gen, dev) for shape in
                     ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, H, D)))
    qk, kk, vk = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention.launches = 0
    out = attn.causal_flash(qk, kk, vk, 256, 256)
    assert fa.flash_attention.launches == 1
    got = torch.autograd.grad(out, (qk, kk, vk), dout)
    # the plain forward's statistics, the same backward
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    po, pm, pl = fa.flash_attention_plain(qh, kh, vh, with_stats=True)
    kr, vr = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    dq, dk, dv = attn._flash_bwd(256, 256, (q, kr, vr, po.transpose(1, 2),
                                            pm, pl), dout)
    kv_of = [i // (H // Hkv) for i in range(H)]
    want = (dq, attn._sum_heads(dk, kv_of, Hkv),
            attn._sum_heads(dv, kv_of, Hkv))
    assert (out.float() - po.transpose(1, 2).float()).abs().max() <= \
        FLASH_ATOL
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        assert err <= BWD_RTOL * top, (err, top)


# ------------------------------------------------- grid-step probing

@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,q_offset,causal", [
    (2, 8, 2, 512, 512, 0, True), (1, 4, 4, 128, 512, 384, True),
    (1, 4, 2, 100, 300, 200, True), (2, 4, 2, 256, 256, 0, False)])
def test_flash_counter_block_matches_plain(dev, B, H, Hkv, Sq, Skv, q_offset,
                                           causal):
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _bf16((B, H, Sq, 64), gen, dev)
    k, v = (_bf16((B, Hkv, Skv, 64), gen, dev) for _ in range(2))
    out, counts = fa.flash_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, with_probe=True)
    _, want = fa.flash_attention_plain(q, k, v, causal=causal,
                                       q_offset=q_offset, with_probe=True)
    assert torch.equal(counts, want)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal,
                                               q_offset=q_offset))


@pytest.mark.parametrize("dtype,L,chunk,pipeline,G,H", [
    (torch.bfloat16, 1024, 256, 1, 1, 32), (torch.bfloat16, 512, 256, 2, 2, 8),
    (torch.float32, 384, 128, 4, 1, 4)])
def test_ssd_counter_block_matches_plain(dev, dtype, L, chunk, pipeline, G,
                                         H):
    B, P, N = 2, 64, 128
    gen = torch.Generator(device=dev).manual_seed(10)
    x = (0.5 * torch.randn((B, L, H, P), generator=gen, device=dev)).to(dtype)
    a = -0.3 * torch.rand((B, L, H), generator=gen, device=dev)
    b, c = ((0.5 * torch.randn((B, L, G, N), generator=gen, device=dev)
             ).to(dtype) for _ in range(2))
    kw = dict(chunk=chunk, h_per_g=H // G, pipeline=pipeline)
    y, counts = ssd._ssd(x, a, b, c, chunk // pipeline, chunk, H // G,
                         pipeline, False, True)
    _, want = ssd.ssd_scan_plain(x, a, b, c, with_counts=True, **kw)
    assert torch.equal(counts, want)
    assert torch.equal(y, ssd.ssd_scan(x, a, b, c, **kw))


@pytest.mark.parametrize("pos", [[543] * 8, [0, 63, 64, 65, 127, 300, 500,
                                             543]])
def test_paged_counter_block_matches_plain(dev, pos):
    B, kv, g, hd, ps, n_pages, P = 8, 4, 8, 64, 16, 34, 280
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, kv, g, hd), generator=gen, device=dev)
    pk, pv = (_bf16((P, ps, kv, hd), gen, dev) for _ in range(2))
    pages = torch.randperm(P - 1, generator=gen, device=dev)[:B * n_pages]
    pages = (pages + 1).to(torch.int32).reshape(B, n_pages)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    out, counts = pa._paged(q, pk, pv, pages, pos, True)
    _, want = pa.paged_attention_plain(q, pk, pv, pages, pos,
                                       with_counts=True)
    assert torch.equal(counts, want)
    assert torch.equal(out, pa.paged_attention(q, pk, pv, pages, pos))


@pytest.mark.parametrize("seed", range(4))
def test_probe_grid_kernel_matches_plain(dev, seed):
    """Random plans (every rule), counter blocks, ids, spill flags and
    prior calls: the CUDA fold equals its plain version, state and
    spilled rows, integer for integer; then a flash-sized plan (16384
    steps) without spills."""
    import numpy as np
    from repro_torch.core import init_state
    from repro_torch.core import kernelprobe as kp
    from repro_torch.kernels import probe_events as kpe
    rng = np.random.default_rng(seed)
    rows_n, last = int(rng.integers(1, 40)), int(rng.integers(2, 70))
    kv, nt, tile, sps = 2, 3, 4, int(rng.integers(1, 4))
    rules = [kp.FIRST, kp.LAST, kp.BELOW, kp.AT_END, kp.CONST]
    scopes = [kp.GridScope(f"s{j}", r, tuple(
        int(x) for x in rng.integers(0, 1 << 20, 2)))
        for j, r in enumerate(rules)]
    scopes.append(kp.GridScope("cnt", kp.COUNT, tuple(
        int(x) for x in rng.integers(0, 50, 4))))
    scopes.append(kp.GridScope("slots", kp.SLOTS, tuple(
        int(x) for x in rng.integers(0, 50, kv * 6 + 1))))
    shape = (rows_n * max(last, 6) * 2,)
    counters = rng.integers(-1, last + 2, shape).astype(np.int32)
    plan = kp.GridPlan(body="k", grid=(rows_n, last),
                       transfer=int(rng.integers(0, 99)),
                       scopes=tuple(scopes), counter_shape=shape,
                       expected=lambda: counters, mirror=lambda: counters,
                       geom=(kv, nt, tile, sps))
    n, depth = len(scopes) + 4, int(rng.integers(1, 6))
    ids = [int(i) for i in rng.permutation(n)[:len(scopes) + 1]]
    ids[int(rng.integers(len(ids)))] = -1
    spill = [bool(x) for x in rng.integers(0, 2, len(ids))]
    base = init_state(n, depth, device="cpu")
    base["calls"].copy_(torch.from_numpy(rng.integers(0, 9, n)))
    base["cycle"].fill_(int(rng.integers(0, 1 << 30)))
    base["ring"].copy_(torch.from_numpy(rng.integers(0, 99, (n, depth, 2))))
    rows, offs = kpe.grid_dump_rows(base["calls"].tolist(), ids, spill,
                                    plan.steps, depth)
    cpu = {k: v.clone() for k, v in base.items()}
    gpu = {k: v.to(dev) for k, v in base.items()}
    dump_c = torch.zeros((max(len(rows), 1), depth, 2), dtype=torch.int64)
    dump_g = dump_c.to(dev)
    kpe.probe_grid(cpu, plan, torch.from_numpy(counters), ids, spill, dump_c,
                   offs)
    kpe.probe_grid(gpu, plan, torch.from_numpy(counters).to(dev), ids, spill,
                   dump_g, offs)
    for k in cpu:
        assert torch.equal(cpu[k], gpu[k].cpu()), k
    assert torch.equal(dump_c, dump_g.cpu())

    q = torch.zeros((8, 32, 512, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((8, 4, 512, 64), dtype=torch.bfloat16, device=dev)
    big = fa.flash_plan(q, kv, kv)
    _, counts = fa.flash_attention(q, kv, kv, with_probe=True)
    cpu, gpu = init_state(4, 4, "cpu"), init_state(4, 4, dev)
    kpe.probe_grid(cpu, big, counts.cpu(), [0, 1, 2, 3], [False] * 4)
    kpe.probe_grid(gpu, big, counts, [0, 1, 2, 3], [False] * 4)
    for k in cpu:
        assert torch.equal(cpu[k], gpu[k].cpu()), k
    assert int(cpu["cycle"]) == big.cycles(big.expected())


@pytest.mark.parametrize("name", ["flash", "ssd", "paged"])
def test_kernel_probe_on_the_card_equals_oracle(dev, name):
    """Each kernel probed inside a scan of 2 (``kernel_probes=("*",)``):
    record == oracle, outputs bitwise the unprobed ones, one fold per
    kernel call, with and without offload."""
    from repro_torch.core import (ProbeConfig, decode_record, probe, scope)
    from repro_torch.kernels import probe_events as kpe
    gen = torch.Generator(device=dev).manual_seed(12)
    if name == "flash":
        args = (_bf16((2, 8, 256, 64), gen, dev),
                _bf16((2, 2, 256, 64), gen, dev),
                _bf16((2, 2, 256, 64), gen, dev))

        def call(q, k, v):
            return fa.flash_attention(q, k, v)
    elif name == "ssd":
        B, L, H, G = 2, 512, 8, 1
        args = ((0.5 * torch.randn((B, L, H, 64), generator=gen, device=dev)
                 ).to(torch.bfloat16),
                -0.3 * torch.rand((B, L, H), generator=gen, device=dev),
                _bf16((B, L, G, 128), gen, dev), _bf16((B, L, G, 128), gen,
                                                       dev))

        def call(x, a, b, c):
            return ssd.ssd_scan(x, a, b, c, chunk=256, h_per_g=H // G,
                                pipeline=2)
    else:
        B, kv, P = 4, 4, 40
        pages = (torch.randperm(P - 1, generator=gen, device=dev)[:B * 8]
                 + 1).to(torch.int32).reshape(B, 8)
        args = (torch.randn((B, kv, 8, 64), generator=gen, device=dev),
                _bf16((P, 16, kv, 64), gen, dev),
                _bf16((P, 16, kv, 64), gen, dev), pages,
                torch.tensor([0, 17, 64, 127], dtype=torch.int32, device=dev))

        def call(*a):
            return pa.paged_attention(*a, pos_host=(0, 17, 64, 127))

    def fn(*a):
        outs = []
        with scope.named_scope("layers"):
            for _ in scope.scan(2):
                with scope.named_scope("k"):
                    outs.append(call(*a))
        return outs
    for offload in (0.0, 1.0):
        pf = probe(fn, ProbeConfig(inline="off_all", kernel_probes=("*",),
                                   offload=offload, buffer_depth=4))
        pf.ensure_built(*args)
        kpe.probe_grid.launches = 0
        out, rec = pf(*args)
        torch.cuda.synchronize()
        assert kpe.probe_grid.launches == 2 == pf.last_run["folds"]
        assert all(torch.equal(a, b) for a, b in zip(out, fn(*args)))
        oc = pf.oracle(*args)
        dec = decode_record(rec)
        assert dec["cycle"] == oc.cycle
        for key in ("starts", "ends", "totals", "calls"):
            assert [int(x) for x in dec[key]] == getattr(oc, key), key
        rows = pf.report(rec).rows
        for i, row in enumerate(rows):
            if pf.assignment.spill[i]:
                assert row.iters == oc.history[i], row.path


# ---------------------------------------------------------------- tiles
# every (block_q, block_k) of the flash kernel and every tile_slots of the
# paged kernel, against its plain version at that tile, with the declared
# shared memory against ``cudaFuncGetAttributes``'

@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("block_q,block_k",
                         [(bq, bk) for bq in fa.BLOCKS_Q for bk in fa.BLOCKS_K])
def test_flash_kernel_tiles_match_plain(dev, block_q, block_k, D):
    tiles = dict(block_q=block_q, block_k=block_k)
    gen = torch.Generator(device=dev).manual_seed(block_q + block_k + D)
    q = _bf16((2, 8, 300, D), gen, dev)
    k, v = _bf16((2, 2, 300, D), gen, dev), _bf16((2, 2, 300, D), gen, dev)
    smem = fa.flash_smem_bytes(D, block_q, block_k)
    if smem > 232448:
        with pytest.raises(ValueError, match="shared memory"):
            fa.flash_attention(q, k, v, **tiles)
        return
    attrs = fa.flash_attrs(D, block_q, block_k)
    assert attrs["dynamic_smem"] == smem and attrs["static_smem"] == 0
    assert attrs["max_threads"] >= 2 * block_q * 2
    # the driver fits the CTAs an SM the tile was compiled for
    assert attrs["ctas_per_sm"] >= fa.flash_min_blocks(D, block_q, block_k)
    outs = {}
    for causal in (True, False):
        out, probe, m, l = fa.flash_attention(
            q, k, v, causal=causal, with_probe=True, with_stats=True, **tiles)
        ref, probe_ref, m_ref, l_ref = fa.flash_attention_plain(
            q, k, v, causal=causal, with_probe=True, with_stats=True, **tiles)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL
        assert torch.equal(probe, probe_ref)
        assert torch.allclose(m, m_ref, atol=1e-4, rtol=0)
        assert torch.allclose(l, l_ref, atol=0, rtol=1e-4)
        outs[causal] = out
    # the output without statistics or counts is the same launch's, and
    # rows at a q offset equal the whole call's
    whole = fa.flash_attention(q, k, v, **tiles)
    assert torch.equal(whole, outs[True])
    for off, n in ((200, 100), (37, 90)):
        part = fa.flash_attention(q[:, :, off:off + n].contiguous(), k, v,
                                  q_offset=off, **tiles)
        assert torch.equal(part, whole[:, :, off:off + n]), (off, n)


@pytest.mark.parametrize("tile_slots", pa.TILES)
@pytest.mark.parametrize("hd,g", [(64, 8), (128, 16), (64, 1)])
def test_paged_kernel_tiles_match_plain(dev, tile_slots, hd, g):
    T, ps, n_pages = tile_slots, 16, 34
    pos = [0, T - 1, T, T + 1, 2 * T - 1, 2 * T, ps * n_pages - 1, 300]
    args = _paged_case(dev, len(pos), 4, g, hd, ps, n_pages, pos, seed=T + g)
    if max(pa.paged_smem_bytes(hd, g, T)) > 48 * 1024:
        with pytest.raises(ValueError, match="static shared memory"):
            pa.paged_attention(*args, tile_slots=T)
        return
    out, counts = pa._paged(*args, with_counts=True, tile_slots=T)
    ref, counts_ref = pa.paged_attention_plain(*args, with_counts=True,
                                               tile_slots=T)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= PAGED_ATOL
    assert torch.equal(counts, counts_ref)
    assert torch.equal(pa.paged_attention(*args, tile_slots=T), out)
    q, pool_k, pool_v, pages, posd = args
    for b in (0, 3, 7):
        one = pa.paged_attention(q[b:b + 1], pool_k, pool_v, pages[b:b + 1],
                                 posd[b:b + 1], tile_slots=T)
        assert torch.equal(one, out[b:b + 1]), b
    attrs = pa.paged_attrs(hd, g, T)
    assert (attrs["stats_smem"], attrs["output_smem"]) == \
        pa.paged_smem_bytes(hd, g, T)
