"""The port's hand-written CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere. Imports nothing of JAX, so
it runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from genima_torch.kernels import flash_attention as fa
from genima_torch.kernels import packed_attention as pa

# the SD-turbo levels at 64x64 latents, B=1 (what the main path launches),
# plus a batched, rectangular case
SHAPES = [
    (1, 4096, 4096, 320, 5),
    (1, 1024, 1024, 640, 10),
    (1, 256, 256, 1280, 20),
    (2, 256, 512, 128, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,h", SHAPES)
def test_packed_attention_kernel_matches_plain_version(cuda, b, sq, sk, c, h):
    rng = np.random.RandomState(sq + sk)
    q, k, v = (
        torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(cuda).bfloat16()
        for s in (sq, sk, sk)
    )
    before = pa.packed_flash_attention.launches
    got = pa.packed_flash_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert pa.packed_flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = pa.packed_attention_reference(q, k, v, h)
    # bf16 output and bf16-rounded P: ~2^-8 relative on O(1) values
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_packed_attention_kernel_rejects_unsupported_shapes(cuda):
    q = torch.zeros(1, 320, 128, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 100, 2, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):  # B2b's tiles; B1 takes any length
        pa.packed_attention_backward(*(q[:, :100],) * 4, lse, q[:, :100], 2)
    with pytest.raises(ValueError, match="bfloat16 or float32"):  # f32 has its kernel now
        pa.packed_flash_attention(q.half(), q.half(), q.half(), 2)


# the three SD levels at 64x64 latents, at B=1 and at the trainer's B=4
TRAIN_SHAPES = [
    (b, s, c, h)
    for b in (1, 4)
    for s, c, h in ((4096, 320, 5), (1024, 640, 10), (256, 1280, 20))
]
LSE_ATOL = 2e-3  # f32 log-sum-exp of O(1) scores over <= 4096 keys
GRAD_REL_TOL = 2e-2  # bf16 dq/dk/dv and bf16-rounded P, dS, relative to max |grad|


def _bf16_inputs(cuda, b, s, c, seed, n=4):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, c, generator=gen, device=cuda).bfloat16() for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", TRAIN_SHAPES)
def test_lse_forward_kernel_matches_plain_version(cuda, b, s, c, h):
    q, k, v = _bf16_inputs(cuda, b, s, c, seed=s + b, n=3)
    before = pa.packed_attention_forward_lse.launches
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    torch.cuda.synchronize()
    assert pa.packed_attention_forward_lse.launches == before + 1
    assert lse.shape == (b, s, h) and lse.dtype == torch.float32
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    # the output is B1's, bit for bit: the same kernel with one more store
    assert torch.equal(o, pa.packed_flash_attention(q, k, v, h))


# B1/B2a's plans: every instantiation at every ring depth it can take, at the
# three SD levels (batch 2)
FORWARD_LEVELS = [(2, s, c, h) for _, s, c, h in TRAIN_SHAPES[:3]]


@pytest.mark.cuda
@pytest.mark.parametrize("nwg,bn", pa.FORWARD_TILES)
@pytest.mark.parametrize("b,s,c,h", FORWARD_LEVELS)
def test_packed_attention_every_plan_matches_plain_version(cuda, monkeypatch, nwg, bn, b, s, c, h):
    q, k, v = _bf16_inputs(cuda, b, s, c, seed=nwg * bn + s, n=3)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    tiles = -(-s // bn)
    for stages in range(2 if tiles > 1 else 1, min(tiles, fa.MAX_STAGES) + 1):
        p = pa.make_forward_plan(b, s, s, h, nwg, bn, stages)
        monkeypatch.setattr(pa, "_plan_for", lambda *a, p=p: p)
        o1 = pa.packed_flash_attention(q, k, v, h)
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1.float(), o_ref.float(), atol=1e-2, rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
        assert torch.equal(o, o1)


def _forward_into(out, lse, q, k, v, h, p):
    """B2a straight through the C entry point, into caller-owned o and L
    that may reach past q's batch."""
    lib = pa._library()
    b, sq, c = q.shape
    rc = lib.packed_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq,
        k.shape[1], h, c // h, c // h, p.nwg, p.bn, p.stages, p.splits,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, lib.packed_attention_error_string(rc)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [192, 320])
@pytest.mark.parametrize("sk", [64, 512])
def test_packed_attention_ragged_block_stays_in_its_batch(cuda, sq, sk):
    """Sq an odd multiple of 64 leaves the last 128- or 192-row block partly
    past Sq, where the contiguous (B, Sq, .) outputs hold the next batch's
    rows. At every tile, batch 2: both batches match the plain version
    through the wrapper, and written into outputs one batch longer (filled
    with NaN), the extra batch of o and L stays untouched."""
    b, c, h = 2, 320, 5
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(b, sq, c, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(b, sk, c, generator=gen, device=cuda).bfloat16() for _ in range(2))
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    for nwg, bn in pa.FORWARD_TILES:
        p = pa.make_forward_plan(b, sq, sk, h, nwg, bn)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pa, "_plan_for", lambda *a, p=p: p)
            o, lse = pa.packed_attention_forward_lse(q, k, v, h)
            o1 = pa.packed_flash_attention(q, k, v, h)
        out = torch.full((b + 1, sq, c), float("nan"), device=cuda, dtype=torch.bfloat16)
        lse_out = torch.full((b + 1, sq, h), float("nan"), device=cuda)
        _forward_into(out, lse_out, q, k, v, h, p)
        torch.cuda.synchronize()
        for i in range(b):
            torch.testing.assert_close(o[i].float(), o_ref[i].float(), atol=1e-2, rtol=0)
            torch.testing.assert_close(lse[i], lse_ref[i], atol=LSE_ATOL, rtol=0)
        assert torch.equal(o, o1) and torch.equal(out[:b], o) and torch.equal(lse_out[:b], lse)
        assert torch.isnan(out[b].float()).all() and torch.isnan(lse_out[b]).all(), (nwg, bn)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", TRAIN_SHAPES)
def test_backward_kernel_matches_plain_version(cuda, b, s, c, h):
    q, k, v, do = _bf16_inputs(cuda, b, s, c, seed=2 * s + b)
    o, lse = pa.packed_attention_lse_reference(q, k, v, h)
    before = pa.packed_attention_backward.launches
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    torch.cuda.synchronize()
    assert pa.packed_attention_backward.launches == before + 1
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        rel = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert rel <= GRAD_REL_TOL, f"{name}: max err {rel} of max |grad|"


def _backward_inputs(cuda, b, sq, sk, c, h, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, sq, c, generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, sk, c, generator=gen, device=cuda).bfloat16() for _ in range(2))
    o, lse = pa.packed_attention_lse_reference(q, k, v, h)
    return q, k, v, o, lse, do


# Sq != Sk both ways, at the trainer's widths and with Sq and Sk odd
# multiples of 64 (the last 128-row block of each kernel half empty)
BWD_RECT_SHAPES = [
    (2, 1024, 4096, 320, 5), (2, 4096, 1024, 320, 5), (2, 192, 320, 320, 5),
    (1, 320, 64, 128, 2), (3, 64, 192, 64, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,h", BWD_RECT_SHAPES)
def test_backward_kernel_matches_plain_version_when_sq_differs_from_sk(cuda, b, sq, sk, c, h):
    q, k, v, o, lse, do = _backward_inputs(cuda, b, sq, sk, c, h, seed=sq + 3 * sk)
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    torch.cuda.synchronize()
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        rel = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert rel <= GRAD_REL_TOL, f"{name}: max err {rel} of max |grad|"


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,h", [(4, 4096, 4096, 320, 5), (4, 1024, 1024, 640, 10),
                                         (2, 192, 320, 320, 5)])
def test_backward_kernel_is_bit_deterministic(cuda, b, sq, sk, c, h):
    """Two kernels and no atomics: every dq, dk and dv element is summed by
    one thread in a fixed order, so repeated calls give the same bits."""
    q, k, v, o, lse, do = _backward_inputs(cuda, b, sq, sk, c, h, seed=b + sq)
    first = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    for _ in range(3):
        again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        for x, y in zip(again, first):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_requires_grad_on_cuda_gets_gradients(cuda):
    """A CUDA call under autograd stays on the graph: B2a forward, B2b
    backward, no B1 launch, no fallback; the gradients are the plain ones."""
    q, k, v, do = _bf16_inputs(cuda, 2, 256, 128, seed=9)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = [pa.packed_flash_attention.launches, pa.packed_attention_forward_lse.launches,
              pa.packed_attention_backward.launches, pa.PackedFlashAttention.fallbacks]
    out = pa.packed_flash_attention(*leaves, 2)
    assert out.grad_fn is not None and out.requires_grad
    out.backward(do)
    torch.cuda.synchronize()
    assert [pa.packed_flash_attention.launches, pa.packed_attention_forward_lse.launches,
            pa.packed_attention_backward.launches, pa.PackedFlashAttention.fallbacks] == [
        counts[0], counts[1] + 1, counts[2] + 1, counts[3]]
    o, lse = pa.packed_attention_lse_reference(q, k, v, 2)
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, 2)
    for x, y in zip(leaves, want):
        assert x.grad is not None
        rel = ((x.grad.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert rel <= GRAD_REL_TOL


# ---------------------------------------------------------------------------
# B1, B2a, B2b at every head dim (multiples of 8 up to 160: the tiny
# configs' 16/32, SD-1.5's 40/80/160) and at the SD levels of 768x768 (9216
# and 2304 tokens)
# ---------------------------------------------------------------------------

HEAD_DIMS = [16, 32, 40, 80, 128, 160]
# (B, S, C, heads) of SD-1.5 (8 heads at every level) at the trainer's batch
SD15_SHAPES = [(4, 4096, 320, 8), (4, 1024, 640, 8), (4, 256, 1280, 8)]
# the SD levels at 768x768: B1 at batch 1, B2b on one sample (the plain
# backward's f32 scores of a 9216-token row take 1.7 GB a head)
LONG_SHAPES = [(1, 9216, 320, 5), (1, 2304, 640, 10)]


def _check_packed_attention(q, k, v, do, h):
    """B1, B2a (o bit-equal to B1's, L) and B2b against the plain versions."""
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    o1 = pa.packed_flash_attention(q, k, v, h)
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    torch.cuda.synchronize()
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    assert torch.equal(o, o1)
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == torch.bfloat16, name
        rel = ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
        assert rel <= GRAD_REL_TOL, f"{name}: max err {rel} of max |grad|"


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("h", [1, 3])
def test_packed_attention_at_every_head_dim_matches_plain_version(cuda, d, h):
    """Batch 2, 320 tokens (an odd multiple of 64: the last 128-row block
    half empty), one or three heads: the last head's atoms reach past C,
    the others' into the next head's columns."""
    q, k, v, do = _bf16_inputs(cuda, 2, 320, h * d, seed=d + h)
    _check_packed_attention(q, k, v, do, h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", SD15_SHAPES)
def test_packed_attention_at_sd15_levels_matches_plain_version(cuda, b, s, c, h):
    q, k, v, do = _bf16_inputs(cuda, b, s, c, seed=s + c)
    _check_packed_attention(q, k, v, do, h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", LONG_SHAPES)
def test_packed_attention_past_4096_tokens_matches_plain_version(cuda, b, s, c, h):
    q, k, v, do = _bf16_inputs(cuda, b, s, c, seed=s)
    _check_packed_attention(q, k, v, do, h)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 160])
@pytest.mark.parametrize("nwg,bn", pa.WIDE_FORWARD_TILES)
def test_packed_attention_every_wide_plan_matches_plain_version(cuda, monkeypatch, d, nwg, bn):
    """Two- and three-atom heads: each instantiation at every ring depth
    shared memory leaves it, batch 2 x 1024 tokens x 2 heads."""
    b, s, h = 2, 1024, 2
    q, k, v = _bf16_inputs(cuda, b, s, h * d, seed=nwg + d, n=3)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    deepest = fa.max_stages(nwg, bn, fa.head_atoms(d))
    for stages in range(2, deepest + 1):
        p = pa.make_forward_plan(b, s, s, h, nwg, bn, stages, d=d)
        monkeypatch.setattr(pa, "_plan_for", lambda *a, p=p: p)
        o1 = pa.packed_flash_attention(q, k, v, h)
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1.float(), o_ref.float(), atol=1e-2, rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
        assert torch.equal(o, o1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_backward_kernel_at_wide_heads_is_bit_deterministic(cuda, d):
    q, k, v, o, lse, do = _backward_inputs(cuda, 2, 320, 192, 2 * d, 2, seed=d)
    first = pa.packed_attention_backward(q, k, v, o, lse, do, 2)
    again = pa.packed_attention_backward(q, k, v, o, lse, do, 2)
    for x, y in zip(again, first):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# every head dim from 1 to 256: four atoms (200..256) and dims that are not a
# multiple of 8 (zero-padded to the next one by the wrappers)
# ---------------------------------------------------------------------------

ANY_HEAD_DIMS = [36, 100, 168, 200, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("d", ANY_HEAD_DIMS + [1, 7])
def test_packed_attention_at_any_head_dim_matches_plain_version(cuda, d):
    """B1, B2a and B2b at batch 2, 320 tokens (an odd multiple of 64: the
    last 128-row block half empty; at four atoms the blocks are 64 rows)
    and three heads, against the plain versions."""
    q, k, v, do = _bf16_inputs(cuda, 2, 320, 3 * d, seed=d)
    _check_packed_attention(q, k, v, do, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
@pytest.mark.parametrize("sq,sk", [(200, 129), (130, 77), (1024, 1024)])
def test_flash_attention_at_any_head_dim_matches_plain_version(cuda, d, sq, sk):
    """B3 across ragged tile edges and over the 77 prompt tokens."""
    gen = torch.Generator(device=cuda).manual_seed(d + sq + sk)
    q, k, v = (torch.randn(2, s, 3, d, generator=gen, device=cuda).bfloat16()
               for s in (sq, sk, sk))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.shape == q.shape
    torch.testing.assert_close(got.float(), fa.flash_attention_reference(q, k, v).float(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 256])
def test_four_atom_plans_at_every_ring_depth_match_plain_version(cuda, monkeypatch, d):
    """B1/B2a's and B3's four-atom instantiations at every ring depth that
    shared memory leaves them."""
    b, s, h = 2, 1024, 2
    q, k, v = _bf16_inputs(cuda, b, s, h * d, seed=d + 1, n=3)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    for nwg, bn in pa.WIDEST_FORWARD_TILES:
        for stages in range(2, fa.max_stages(nwg, bn, 4) + 1):
            p = pa.make_forward_plan(b, s, s, h, nwg, bn, stages, d=d)
            monkeypatch.setattr(pa, "_plan_for", lambda *a, p=p: p)
            o1 = pa.packed_flash_attention(q, k, v, h)
            o, lse = pa.packed_attention_forward_lse(q, k, v, h)
            torch.cuda.synchronize()
            torch.testing.assert_close(o1.float(), o_ref.float(), atol=1e-2, rtol=0)
            torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
            assert torch.equal(o, o1)
    for nwg, bn in fa.WIDEST_TILES:
        sk = 77 if bn == 80 else 1024
        q4, k4, v4 = (x.view(b, -1, h, d)[:, :n] for x, n in ((q, 200), (k, sk), (v, sk)))
        q4, k4, v4 = (x.contiguous() for x in (q4, k4, v4))
        want = fa.flash_attention_reference(q4, k4, v4).float()
        tiles = -(-sk // bn)
        for stages in range(2 if tiles > 1 else 1, min(tiles, fa.max_stages(nwg, bn, 4)) + 1):
            p = fa.make_plan(b, 200, sk, h, nwg, bn, stages, d=d)
            monkeypatch.setattr(fa, "_plan_for", lambda *a, p=p: p)
            got = fa.flash_attention(q4, k4, v4)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [36, 200, 256])
def test_backward_kernel_at_any_head_dim_is_bit_deterministic(cuda, d):
    q, k, v, o, lse, do = _backward_inputs(cuda, 2, 320, 192, 2 * d, 2, seed=d)
    first = pa.packed_attention_backward(q, k, v, o, lse, do, 2)
    again = pa.packed_attention_backward(q, k, v, o, lse, do, 2)
    for x, y in zip(again, first):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_autograd_at_a_padded_head_dim_matches_plain_version(cuda):
    """``PackedFlashAttention`` at d = 36 (B2a forward, B2b backward, both
    on zero-padded 40-column heads) against the plain version's autograd."""
    q, k, v, do = _bf16_inputs(cuda, 2, 256, 5 * 36, seed=36)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fallbacks = pa.PackedFlashAttention.fallbacks
    out = pa.packed_flash_attention(*leaves, 5)
    out.backward(do)
    assert pa.PackedFlashAttention.fallbacks == fallbacks
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    pa.packed_attention_reference(*ref, 5).backward(do)
    torch.testing.assert_close(out.float(), pa.packed_attention_reference(q, k, v, 5).float(),
                               atol=1e-2, rtol=0)
    for name, x, y in zip(("dq", "dk", "dv"), leaves, ref):
        rel = ((x.grad.float() - y.grad.float()).abs().max() / y.grad.float().abs().max()).item()
        assert rel <= GRAD_REL_TOL, f"{name}: max err {rel} of max |grad|"


# ---------------------------------------------------------------------------
# B3, B4, B5: the serving pipeline's opt-in backends
# ---------------------------------------------------------------------------

from genima_torch.kernels import fused_conv as fc  # noqa: E402
from genima_torch.kernels import w8_matmul as w8  # noqa: E402

# (B, Sq, Sk, heads): the "pallas" path's self-attention at the four SD
# levels, its cross-attention over 77 prompt tokens, and ragged edges
FLASH_SHAPES = [
    (1, 4096, 4096, 5), (1, 1024, 1024, 10), (1, 256, 256, 20), (1, 64, 64, 20),
    (1, 4096, 77, 5), (1, 1024, 77, 10), (1, 256, 77, 20), (1, 64, 77, 20),
    (2, 100, 77, 3), (2, 33, 16, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_version(cuda, b, sq, sk, h):
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk)
    q, k, v = (torch.randn(b, s, h, 64, generator=gen, device=cuda).bfloat16()
               for s in (sq, sk, sk))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    # bf16 output and bf16-rounded P: ~2^-8 relative on O(1) values
    torch.testing.assert_close(got.float(), fa.flash_attention_reference(q, k, v).float(),
                               atol=1e-2, rtol=0)


def _flash_inputs(cuda, b, sq, sk, h, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, s, h, 64, generator=gen, device=cuda).bfloat16()
            for s in (sq, sk, sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [130, 200])
@pytest.mark.parametrize("sk", [1, 77, 129])
def test_flash_attention_kernel_across_tile_edges(cuda, sq, sk):
    """Query counts past one and two 64-row tiles and past one 128-row
    block; one key, the 77 prompt tokens (one 80-key tile), one key past a
    128-key tile."""
    q, k, v = _flash_inputs(cuda, 1, sq, sk, 2, seed=sq + sk)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fa.flash_attention_reference(q, k, v).float(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_flash_attention_ragged_tile_stays_in_its_batch(cuda):
    """Batch 2, 77 keys: the last K/V tile of batch 0 reaches past key 77.
    Batch 1's first values are inf, so a tile that read into the next batch
    (instead of TMA's zero fill within it) would turn batch 0's output into
    NaN (0 * inf) even though the mask drops those keys."""
    q, k, v = _flash_inputs(cuda, 2, 130, 77, 2, seed=5)
    v[1, :3] = float("inf")
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    torch.testing.assert_close(got[0].float(), fa.flash_attention_reference(q, k, v)[0].float(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nwg,bn", fa.TILES)
@pytest.mark.parametrize("b,sq,sk,h", [(2, 200, 129, 3), (1, 1024, 1024, 10), (2, 64, 77, 2)])
def test_flash_attention_every_plan_matches_plain_version(cuda, monkeypatch, nwg, bn, b, sq, sk, h):
    """Each (warpgroups, key tile) instantiation forced, at its default ring
    depth and at two stages where it streams more than one tile."""
    q, k, v = _flash_inputs(cuda, b, sq, sk, h, seed=nwg * bn + sq)
    want = fa.flash_attention_reference(q, k, v).float()
    tiles = -(-sk // bn)
    for stages in sorted({fa.make_plan(b, sq, sk, h, nwg, bn).stages, 2 if tiles > 1 else 1}):
        p = fa.make_plan(b, sq, sk, h, nwg, bn, stages)
        monkeypatch.setattr(fa, "_plan_for", lambda *s, p=p: p)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 40, 80, 160])
@pytest.mark.parametrize("sq,sk", [(4096, 4096), (256, 77), (64, 64), (130, 129)])
def test_flash_attention_at_every_head_dim_matches_plain_version(cuda, d, sq, sk):
    """SD-1.5's self- and cross-attention geometry (8 heads), and ragged
    edges."""
    gen = torch.Generator(device=cuda).manual_seed(d + sq + sk)
    q, k, v = (torch.randn(1, s, 8, d, generator=gen, device=cuda).bfloat16()
               for s in (sq, sk, sk))
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fa.flash_attention_reference(q, k, v).float(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 160])
@pytest.mark.parametrize("nwg,bn", fa.WIDE_TILES)
def test_flash_attention_every_wide_plan_matches_plain_version(cuda, monkeypatch, d, nwg, bn):
    b, sq, sk, h = 2, 200, 77 if bn == 80 else 1024, 3
    q, k, v = (torch.randn(b, s, h, d, device=cuda).bfloat16() for s in (sq, sk, sk))
    want = fa.flash_attention_reference(q, k, v).float()
    tiles = -(-sk // bn)
    deepest = fa.max_stages(nwg, bn, fa.head_atoms(d))
    for stages in range(2 if tiles > 1 else 1, min(tiles, deepest) + 1):
        p = fa.make_plan(b, sq, sk, h, nwg, bn, stages, d=d)
        monkeypatch.setattr(fa, "_plan_for", lambda *s, p=p: p)
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_flash_attention_autograd_on_cuda(cuda):
    """The forward launches the kernel; the backward recomputes through the
    plain version and matches its gradients."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(1, s, 2, 64, generator=gen, device=cuda).bfloat16()
                   for s in (96, 77, 77, 96))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.flash_attention.launches
    out = fa.flash_attention(*leaves)
    assert out.grad_fn is not None and fa.flash_attention.launches == before + 1
    out.backward(do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_reference(*ref).backward(do)
    for x, y in zip(leaves, ref):
        torch.testing.assert_close(x.grad, y.grad, atol=0, rtol=0)


# (B, H, W, C, O) of the SD VAE decoder's up blocks and conv_out at 512x512
CONV_SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (1, 512, 512, 128, 3),
]


def _conv_inputs(cuda, b, h, w, c, o, seed, skip=False, res=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=cuda) * s

    x = rnd(b, h, w, c).bfloat16()
    scale, shift = fc.fold_group_norm(x, 1.0 + 0.2 * rnd(c), 0.2 * rnd(c), 8, 1e-6)
    return dict(
        x=x, w=(rnd(3, 3, c, o) / (3 * c ** 0.5)).bfloat16(), b=rnd(o).bfloat16(),
        scale=scale, shift=shift,
        wskip=(rnd(c, o) / c ** 0.5).bfloat16() if skip else None,
        residual=rnd(b, h, w, o).bfloat16() if res else None,
    )


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# every decoder shape through the GN-SiLU prologue; the plain conv and the
# skip + residual variants at conv_out's and at ragged small shapes
CONV_CASES = [(s, "gn_silu") for s in CONV_SHAPES] + [
    (s, v) for s in (CONV_SHAPES[-1], (2, 16, 12, 24, 16), (1, 9, 70, 16, 8))
    for v in ("plain", "skip_residual")
] + [
    # ragged widths (one and a bit, two and a bit 64-column tiles), an odd
    # height, batch 2, C = 136 (two 64-channel bands and an 8-channel one),
    # conv_out's 3 and 256 (two 128-channel tiles), through each variant
    ((2, 33, w, 136, o), v) for w in (66, 130) for o in (3, 256)
    for v in ("gn_silu", "skip_residual")
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,variant", CONV_CASES)
def test_fused_conv_kernel_matches_plain_version(cuda, shape, variant):
    torch.backends.cudnn.allow_tf32 = False  # the plain version's conv in full f32
    i = _conv_inputs(cuda, *shape, seed=sum(shape), skip=variant == "skip_residual",
                     res=variant == "skip_residual")
    if variant == "plain":
        i["scale"] = i["shift"] = None
    before = fc.fused_conv3x3.launches
    got = fc.fused_conv3x3(**i)
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.launches == before + 1
    assert got.shape == (*shape[:3], shape[4]) and got.dtype == torch.bfloat16
    # bf16 activation and output roundings, f32 sums in another order
    assert _rel_err(got, fc.fused_conv3x3_reference(**i)) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("bn,rows", fc.TILES)
def test_fused_conv_every_tile_matches_plain_version(cuda, monkeypatch, bn, rows):
    """Each (output channels, image rows) instantiation, forced on a ragged
    shape with the skip and the residual."""
    torch.backends.cudnn.allow_tf32 = False
    shape = (2, 33, 130, 136, 256 if bn > 16 else 3)
    i = _conv_inputs(cuda, *shape, seed=bn + rows, skip=True, res=True)
    monkeypatch.setattr(fc, "_plan_for", lambda *s: fc.make_plan(*s, bn=bn, rows=rows))
    got = fc.fused_conv3x3(**i)
    torch.cuda.synchronize()
    assert _rel_err(got, fc.fused_conv3x3_reference(**i)) <= 2e-2


# (M, K, N) of every int8 linear on the "+w8" path: proj_in/out and the
# attention projections (C -> C), GEGLU (C -> 8C), its output (4C -> C) at
# the four token counts, and the cross-attention K/V on 77 prompt tokens
W8_SHAPES = sorted(
    {(m, c, c) for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))}
    | {(m, c, 8 * c) for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))}
    | {(m, 4 * c, c) for m, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))}
    | {(77, 1024, c) for c in (320, 640, 1280)}
) + [(5, 48, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8_SHAPES)
def test_w8_matmul_kernel_matches_plain_version(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device=cuda) / k ** 0.5)
    before = w8.w8_matmul.launches
    got = w8.w8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert w8.w8_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    # bf16 output rounding; f32 sums in another order
    assert _rel_err(got, w8.w8_matmul_reference(x, w_q, scale)) <= 1e-2


# shapes that exercise the plan: one token up to two 128-token tiles, K that
# is a multiple of the 128-wide K tile and not (1040 = 8 tiles + 16), N from
# one 8-column group to twenty 64-row tiles; (1, 1040, 1280) splits 9 K
# tiles 4 ways, which does not divide them
W8_PLAN_SHAPES = [(m, k, n) for m in (1, 64, 77, 256) for k in (1024, 1040, 5120)
                  for n in (8, 320, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", W8_PLAN_SHAPES)
def test_w8_matmul_kernel_matches_plain_version_across_plans(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(7 * m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device=cuda) / k ** 0.5)
    got = w8.w8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel_err(got, w8.w8_matmul_reference(x, w_q, scale)) <= 1e-2


def test_w8_plan_shapes_include_a_split_that_does_not_divide_the_k_tiles():
    plans = [w8.plan(m, k, n) for m, k, n in W8_PLAN_SHAPES]
    assert any(p.split > 1 and p.k_tiles % p.split for p in plans)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 5120, 1280), (77, 1024, 320), (256, 1280, 1280),
                                   (1024, 640, 640)])
def test_w8_matmul_is_bit_deterministic(cuda, m, k, n):
    """Split-K partials are summed in split order by whichever block comes
    last, so repeated calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device=cuda) / k ** 0.5)
    first = w8.w8_matmul(x, w_q, scale)
    for _ in range(5):
        assert torch.equal(w8.w8_matmul(x, w_q, scale), first)


# the split-K shapes of the lockstep-batched eval at 4 envs: 4 x 64 tokens
# of the innermost level and 4 x 77 prompt tokens of the cross K/V
W8_TWO_STREAM_SHAPES = [(256, 1280, 1280), (256, 5120, 1280), (308, 1024, 320),
                        (308, 1024, 1280)]


@pytest.mark.cuda
def test_w8_split_k_on_two_streams_at_once_matches_one_after_the_other(cuda):
    """Split-K partials and tile tickets belong to a stream: the same calls
    issued on two streams at once give the bits they give one after the
    other on one stream."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    calls = []
    for m, k, n in W8_TWO_STREAM_SHAPES:
        assert w8.plan(m, k, n).split > 1
        x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
        calls.append((x, *w8.quantize_weight(
            torch.randn(n, k, generator=gen, device=cuda) / k ** 0.5)))
    want = [w8.w8_matmul(*c) for c in calls]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    got = {0: [], 1: []}
    for _ in range(10):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                order = range(len(calls)) if i == 0 else reversed(range(len(calls)))
                got[i] += [(j, w8.w8_matmul(*calls[j])) for j in order]
    torch.cuda.synchronize()
    for i in (0, 1):
        for j, out in got[i]:
            assert torch.equal(out, want[j]), (i, W8_TWO_STREAM_SHAPES[j])
    keys = {key for key in w8._scratch if key[0] == (cuda.index or 0)}
    assert {(cuda.index or 0, s.cuda_stream) for s in streams} <= keys


@pytest.mark.cuda
def test_w8_matmul_autograd_on_cuda(cuda):
    """Under autograd the kernel still runs the forward and the output keeps
    its gradient: dx is the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(77, 1024, generator=gen, device=cuda).bfloat16()
    dy = torch.randn(77, 320, generator=gen, device=cuda).bfloat16()
    w_q, scale = w8.quantize_weight(torch.randn(320, 1024, generator=gen, device=cuda) / 32)
    leaf = x.clone().requires_grad_()
    before = w8.w8_matmul.launches
    out = w8.w8_matmul(leaf, w_q, scale)
    assert out.grad_fn is not None and w8.w8_matmul.launches == before + 1
    out.backward(dy)
    ref = x.clone().requires_grad_()
    w8.w8_matmul_reference(ref, w_q, scale).backward(dy)
    torch.testing.assert_close(leaf.grad, ref.grad, atol=0, rtol=0)


@pytest.mark.cuda
def test_new_kernels_reject_what_they_cannot_take(cuda):
    x = torch.zeros(4, 40, device=cuda, dtype=torch.bfloat16)
    w_q = torch.zeros(8, 40, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8.w8_matmul(x, w_q, torch.ones(8, device=cuda))
    for d in (0,):  # every d >= 1 runs (above 256 on the wide kernels)
        q = torch.zeros(1, 8, 2, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="head_dim"):
            pa.packed_flash_attention(*(q.new_zeros(1, 64, 2 * d),) * 3, 2)
    xc = torch.zeros(1, 4, 4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fc.fused_conv3x3(xc, torch.zeros(3, 3, 12, 8, device=cuda), torch.zeros(8, device=cuda))


@pytest.mark.cuda
def test_async_checkpointer_copies_device_tensors_to_the_host(cuda, tmp_path):
    """``submit`` copies the trees' device tensors (f32, bf16, a transposed
    view, empty, a CPU tensor) into its arenas, grown by a larger second
    tree; an in-place update queued after ``submit`` does not reach the
    file."""
    from genima_torch.core import checkpoint as ckpt

    g = torch.Generator(device=cuda).manual_seed(0)
    writer = ckpt.AsyncCheckpointer()
    for i, rows in enumerate((10, 1000)):
        a = torch.randn(rows, 301, device=cuda, generator=g)
        tree = {"a": a, "at": a.t(), "b": torch.randn(37, device=cuda, generator=g).bfloat16(),
                "c": torch.zeros(0, 3, device=cuda), "cpu": torch.arange(5.0),
                "step": np.asarray(i, np.int32)}
        want = {k: v.cpu().clone(memory_format=torch.contiguous_format)
                if isinstance(v, torch.Tensor) else v for k, v in tree.items()}
        writer.submit(ckpt.save_pytree, tree, tmp_path / f"t{i}.msgpack")
        a.add_(1.0)
        tree["cpu"].add_(1.0)
        writer.wait()
        back = ckpt.load_pytree(tmp_path / f"t{i}.msgpack")
        for k in ("a", "at", "cpu"):
            assert torch.equal(torch.from_numpy(back[k]), want[k]), k
        assert torch.equal(back["b"], want["b"]) and back["c"].shape == (0, 3)
        assert back["step"] == i
    writer.close()


@pytest.mark.cuda
def test_act_update_on_cuda_matches_the_cpu(cuda):
    """One ACT update (augmentation, dropout, the CVAE loss, a binding clip,
    the split AdamW) on the card against the CPU, f32 with TF32 off, from
    the same params, batch and draws; the frozen BatchNorm tensors stay."""
    from genima_torch.control.policy import ACTDraws, GenimaACTAgent
    from genima_torch.data.augment import sample_act_augment_draws
    from genima_torch.nn.act import ACTConfig, RandomDropout, ReplayDropout
    from genima_torch.nn.clip_text import CLIPTextConfig

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        states, agents, modules = {}, {}, {}
        for dev in ("cpu", "cuda"):
            agent = GenimaACTAgent(act_cfg=ACTConfig.tiny(num_queries=6),
                                   clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
                                   resnet_width=8, actor_grad_clip=0.05, device=dev,
                                   dtype=torch.float32)
            params, clip = agent.init_params(torch.Generator(dev).manual_seed(0))
            if dev == "cuda":  # the CPU's seeded weights on both
                for part, module in params.items():
                    module.load_state_dict(modules["cpu"][0][part].state_dict())
                clip.load_state_dict(modules["cpu"][1].state_dict())
            modules[dev] = params, clip
            states[dev], agents[dev] = agent.create_state(params, clip), agent
        rng = np.random.RandomState(0)
        batch = {"images": torch.from_numpy(rng.uniform(0, 255, (2, 4, 32, 32, 3)).astype(np.float32)),
                 "qpos": torch.randn(2, 8), "actions": torch.randn(2, 8, 8),
                 "is_pad": torch.zeros(2, 8, dtype=torch.bool),
                 "lang_tokens": torch.randint(0, 1000, (2, 77))}
        g = torch.Generator(cuda).manual_seed(1)
        aug = sample_act_augment_draws(8, 32, 32, g)
        drop = RandomDropout(g, record=True)
        draws = ACTDraws(aug, torch.randn(2, 8, generator=g, device=cuda), drop)
        before = {k: t.clone() for k, t in states["cuda"].master.items()}
        states["cuda"], m_cuda = agents["cuda"].update(
            states["cuda"], {k: v.to(cuda) for k, v in batch.items()}, draws)
        cpu_draws = ACTDraws(aug._replace(**{f: getattr(aug, f).cpu() for f in
                                             ("elastic", "jitter", "crop", "noise")
                                             if getattr(aug, f) is not None}),
                             draws.latent_eps.cpu(), ReplayDropout([m.cpu() for m in drop.masks]))
        states["cpu"], m_cpu = agents["cpu"].update(states["cpu"], batch, cpu_draws)
        torch.testing.assert_close(m_cuda["loss"].cpu(), m_cpu["loss"], rtol=1e-4, atol=0)
        labels = agents["cuda"].tx.labels
        for k, t in states["cuda"].master.items():
            torch.testing.assert_close(t.cpu(), states["cpu"].master[k], rtol=1e-4, atol=1e-5)
            if labels[k] == "frozen":
                assert torch.equal(t, before[k]), k
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_render_on_cuda_matches_the_cpu(cuda):
    """The sphere renderer and compositors on the card against the CPU on the
    same seeded frames: hit masks by a count (at most 0.1% of pixels, where a
    ray grazes a sphere), images within 1 uint8 level elsewhere except on
    stripe edges (the same 0.1%)."""
    from genima_torch.rendering.render_data import render_frames
    from genima_torch.rendering.spheres import render_spheres

    rng = np.random.RandomState(0)
    n, s, size = 8, 4, 96
    frames = {
        "intr": np.tile(np.array([[80, 0, 48], [0, 80, 48], [0, 0, 1]], np.float32), (n, 1, 1)),
        "pose": np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
        "centers": rng.uniform([-0.3, -0.3, 0.8], [0.3, 0.3, 1.6], (n, s, 3)).astype(np.float32),
        "rots": np.tile(np.eye(3, dtype=np.float32), (n, s, 1, 1)),
        "radii": rng.uniform(0.05, 0.25, (n, s)).astype(np.float32),
        "stripes": rng.uniform(0, 1, (n, s, 3)).astype(np.float32),
        "factors": rng.uniform(0.5, 1, (n, s, 3)).astype(np.float32),
    }
    frames["pose"][:, :3, 3] = rng.uniform(-0.1, 0.1, (n, 3))
    rgb = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    tex = rng.uniform(0, 1, (n, 1, 1, 3)).astype(np.float32)
    blend = rng.uniform(0.7, 1, n).astype(np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            t = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
            keys = ("intr", "pose", "centers", "rots", "radii", "stripes", "factors")
            _, mask = render_spheres(*(t[k] for k in keys), size, size)
            full, rnd = render_frames(t, torch.from_numpy(rgb).to(dev),
                                      torch.from_numpy(tex).to(dev),
                                      torch.from_numpy(blend).to(dev), size, size)
            out[dev] = [x.cpu().numpy().astype(np.int16) for x in (mask, full, rnd)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    total = n * size * size
    assert out["cpu"][0].sum() > 0.05 * total  # the spheres cover the frames in part
    assert (out["cpu"][0] != out["cuda"][0]).sum() <= 1e-3 * total
    for i in (1, 2):
        assert (np.abs(out["cpu"][i] - out["cuda"][i]).max(-1) > 1).sum() <= 1e-3 * total


@pytest.mark.cuda
def test_unet_pretrain_step_on_cuda_matches_library_attention(cuda):
    """One bf16 ``UNetPretrainer`` step's UNet gradients on the card, through
    the packed LSE forward (B2a) and backward (B2b) kernels, against the same
    step with the library attention: relative global-norm difference and the
    worst self-attention projection's within the fine-tune's 0.1
    (``chip_smoke.TRAIN_GRAD_REL_TOL``). 128 channels in 2 heads at 16x16
    latents: 3 self-attentions of 256 tokens with head dim 64 (the mid
    block's 64-token one takes the library attention both ways)."""
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.diffusion.pretrain import UNetPretrainer
    from genima_torch.diffusion.training import TrainConfig
    from genima_torch.nn.clip_text import CLIPTextConfig
    from genima_torch.nn.layers import set_attention_backend
    from genima_torch.nn.unet import UNetConfig
    from genima_torch.nn.vae import VAEConfig

    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(block_out_channels=(128, 128), num_heads=(2, 2)),
        vae_cfg=VAEConfig.tiny_test(), text_cfg=CLIPTextConfig.tiny(), device="cuda",
        vae_encoder=True)
    params = pipe.init_params(torch.Generator(cuda).manual_seed(0))
    trainer = UNetPretrainer(pipe, TrainConfig())
    state = trainer.create_state(params)
    rng = np.random.RandomState(1)
    batch = {"pixel_values": torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)),
             "conditioning_pixel_values": torch.zeros(4, 32, 32, 3, dtype=torch.uint8),
             "input_ids": torch.from_numpy(rng.randint(0, 1000, (4, 77)))}
    draws = trainer.sample_draws(4, 32, torch.Generator(cuda).manual_seed(2))
    counters = (pa.packed_attention_forward_lse, pa.packed_attention_backward)
    before = [f.launches for f in counters]
    grads = {}
    for backend in ("fused", "xla"):
        set_attention_backend(params["unet"], backend)
        grads[backend] = trainer.gradients(state, batch, draws)[1]
        if backend == "fused":
            assert [f.launches - b for f, b in zip(counters, before)] == [3, 3]
    set_attention_backend(params["unet"], "fused")

    def norm(ts):
        return torch.stack([t.norm() for t in ts]).norm().item()

    f, x = grads["fused"], grads["xla"]
    diff = {k: f[k] - x[k] for k in x}
    assert norm(x.values()) > 0
    assert norm(diff.values()) / norm(x.values()) <= 0.1
    attn = [k for k in x if ".attn1.to_" in k and k.endswith("weight")]
    assert len(attn) == 16  # 4 projections x (1 down, 2 up, 1 mid-block) attentions
    assert max(diff[k].norm().item() / x[k].norm().item() for k in attn) <= 0.1


# --- float32: the f32 kernels held to their f32 plain versions, TF32 off ---

F32_TOL = 1e-4  # attention and L max abs err at unit-scale inputs; B2b, B4 / max |grad|, |y|


@pytest.fixture
def no_tf32():
    """The plain versions in full f32: cuBLAS and cuDNN without TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32_inputs(cuda, shapes, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(*s, generator=gen, device=cuda) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,h", [
    (1, 4096, 320, 5), (4, 1024, 640, 10), (4, 256, 1280, 20),  # SD (and SDXL's 1024/256)
    (1, 4096, 320, 8), (4, 1024, 640, 8), (2, 256, 1280, 8),  # SD-1.5: d = 40/80/160
    (1, 9216, 320, 5),  # 768x768
] + [(2, 256, 2 * d, 2) for d in (1, 36, 64, 100, 160, 200, 256)])
def test_f32_packed_kernels_match_plain_versions(cuda, no_tf32, b, s, c, h):
    q, k, v, do = _f32_inputs(cuda, [(b, s, c)] * 4, seed=s + c + h)
    launches = pa.packed_flash_attention.launches
    o1 = pa.packed_flash_attention(q, k, v, h)
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    torch.cuda.synchronize()
    assert pa.packed_flash_attention.launches == launches + 1  # the f32 kernel, no fallback
    assert o1.dtype == o.dtype == torch.float32 and torch.equal(o, o1)
    assert (o1 - o_ref).abs().max().item() <= F32_TOL
    assert (lse - lse_ref).abs().max().item() <= F32_TOL
    if s > 4096:  # the plain backward's f32 scores of 9216 rows: the forward only
        return
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) and x.dtype == torch.float32 for x, y in zip(got, again))
    assert max(_rel_err(x, y) for x, y in zip(got, want)) <= F32_TOL


@pytest.mark.cuda
def test_f32_packed_autograd_runs_b2a_and_b2b(cuda, no_tf32):
    q, k, v, do = _f32_inputs(cuda, [(2, 256, 128)] * 4, seed=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (pa.packed_attention_forward_lse.launches, pa.packed_attention_backward.launches,
              pa.PackedFlashAttention.fallbacks)
    pa.packed_flash_attention(*leaves, 2).backward(do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    pa.packed_attention_reference(*ref, 2).backward(do)
    torch.cuda.synchronize()
    assert (pa.packed_attention_forward_lse.launches, pa.packed_attention_backward.launches,
            pa.PackedFlashAttention.fallbacks) == (counts[0] + 1, counts[1] + 1, counts[2])
    for x, y in zip(leaves, ref):
        assert _rel_err(x.grad, y.grad) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,h", [
    (1, 4096, 4096, 320, 5), (1, 4096, 77, 320, 5), (1, 64, 77, 1280, 20),
    (1, 1024, 77, 640, 8), (2, 130, 129, 12, 4), (1, 1000, 1000, 8 * 36, 8),
    (1, 1000, 77, 8 * 256, 8), (1, 200, 300, 8 * 200, 8)])
def test_f32_flash_attention_matches_plain_version(cuda, no_tf32, b, sq, sk, c, h):
    q, k, v = _f32_inputs(cuda, [(b, sq, h, c // h), (b, sk, h, c // h), (b, sk, h, c // h)],
                          seed=sq + sk)
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and (got - want).abs().max().item() <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,variant", [(s, "gn_silu") for s in CONV_SHAPES] + [
    ((1, 512, 512, 128, 3), "plain"), ((2, 33, 66, 136, 256), "skip_residual"),
    ((1, 9, 70, 16, 8), "skip_residual"),
    # the decoder's 512 -> 512 widths (their gn_silu cases carry the
    # residual) with the 1x1 skip, and without the activation
    ((1, 64, 64, 512, 512), "skip_residual"), ((1, 128, 128, 512, 512), "plain")])
def test_f32_fused_conv_matches_plain_version(cuda, no_tf32, shape, variant):
    b, h, w, c, o = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(b, h, w, c, generator=gen, device=cuda)
    args = dict(x=x, w=torch.randn(3, 3, c, o, generator=gen, device=cuda) / (3 * c ** 0.5),
                b=torch.randn(o, generator=gen, device=cuda), scale=None, shift=None,
                wskip=None, residual=None)
    if variant != "plain":
        args["scale"], args["shift"] = fc.fold_group_norm(
            x, 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda),
            0.2 * torch.randn(c, generator=gen, device=cuda), 8, 1e-6)
    if variant == "skip_residual" or (variant == "gn_silu" and c == o):
        args["residual"] = torch.randn(b, h, w, o, generator=gen, device=cuda)
    if variant == "skip_residual":
        args["wskip"] = torch.randn(c, o, generator=gen, device=cuda) / c ** 0.5
    launches = fc.fused_conv3x3.launches
    got = fc.fused_conv3x3(*args.values())
    want = fc.fused_conv3x3_reference(*args.values())
    torch.cuda.synchronize()
    assert fc.fused_conv3x3.launches == launches + 1
    assert got.dtype == torch.float32 and _rel_err(got, want) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 320, 2560), (4096, 1280, 320), (77, 1024, 1280),
                                   (64, 1280, 10240), (5, 48, 24),
                                   # split-K (4 and 2 ways), ragged M split 8 ways
                                   (64, 5120, 1280), (256, 1280, 1280), (77, 1024, 320)])
def test_f32_w8_matmul_matches_plain_version_bit_for_bit_twice(cuda, no_tf32, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen, device=cuda)
    w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device=cuda) / k ** 0.5)
    got = w8.w8_matmul(x, w_q, scale)
    again = w8.w8_matmul(x, w_q, scale)
    want = w8.w8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    # x rounded to bf16 in the kernel as in the plain version: f32 sums in another order
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_f32_plans_match_the_sources_shared_memory(cuda):
    lib, blib = pa._library(), pa._bwd_library()
    for d in (1, 36, 64, 65, 128, 129, 192, 193, 256):
        dp = fa.f32_padded_head_dim(d)
        for sk in (64, 4096):
            plan = pa._plan_for(1, 4096, sk, 1, d, dtype=torch.float32)
            assert lib.packed_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                       dp) == plan.smem_bytes
        for sk in (77, 4096):
            plan = fa._plan_for(1, 4096, sk, 1, d, dtype=torch.float32)
            assert fa._library().flash_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                                dp) == plan.smem_bytes
        bp = pa.backward_plan(1, 64, 64, 1, d, dtype=torch.float32)
        assert [blib.packed_attention_bwd_f32_smem_bytes(x, dp) for x in (0, 1)] == [
            bp.dq_smem_bytes, bp.dkdv_smem_bytes]
    for o in (3, 128):
        plan = fc._plan_for(1, 8, 8, 16, o, dtype=torch.float32)
        assert fc._library().fused_conv3x3_f32_smem_bytes(plan.bn, plan.rows) == plan.smem_bytes
    for m, k, n in ((1, 16, 8), (64, 5120, 1280), (77, 1024, 320), (4096, 320, 320)):
        plan = w8._plan_for(m, k, n, dtype=torch.float32)
        assert w8._library().w8_matmul_f32_smem_bytes(plan.bt, plan.stages) == plan.smem_bytes


# heads wider than 256 columns: the wide kernels (B1/B2a/B3 at five or six
# atoms paired, above and B2b in chunks of O, dQ, dK, dV), bf16 and f32
WIDE_HEAD_DIMS = [320, 640]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_head_kernels_match_plain_versions(cuda, no_tf32, dtype, d):
    b, s, h = 2, 256, 2
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (torch.randn(b, s, h * d, generator=gen, device=cuda).to(dtype)
                   for _ in range(4))
    tol, lse_tol, grad_tol = ((F32_TOL,) * 3 if dtype == torch.float32
                              else (1e-2, LSE_ATOL, GRAD_REL_TOL))
    o1 = pa.packed_flash_attention(q, k, v, h)
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    q4, k4, v4 = (x.view(b, s, h, d) for x in (q, k, v))
    k77, v77 = (x[:, :77].contiguous() for x in (k4, v4))  # the prompt's 77 keys
    o3 = fa.flash_attention(q4, k77, v77)
    o3_ref = fa.flash_attention_reference(q4, k77, v77)
    torch.cuda.synchronize()
    assert torch.equal(o, o1) and o1.dtype == dtype
    assert (o1.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= lse_tol
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert max(_rel_err(x, y) for x, y in zip(got, want)) <= grad_tol
    assert (o3.float() - o3_ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b1_takes_kv77_on_the_card(cuda, no_tf32, dtype):
    gen = torch.Generator(device=cuda).manual_seed(77)
    q = torch.randn(1, 128, 320, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(1, 77, 320, generator=gen, device=cuda).to(dtype) for _ in range(2))
    launches = pa.packed_flash_attention.launches
    got = pa.packed_flash_attention(q, k, v, 5)
    want = pa.packed_attention_reference(q, k, v, 5)
    torch.cuda.synchronize()
    assert pa.packed_flash_attention.launches == launches + 1
    tol = F32_TOL if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kv77_autograd_runs_b1_and_recomputes_the_gradient(cuda):
    """The repaired fallback: the forward is B1's kernel, the gradient the
    plain version's, as JAX's ``_fwd`` / ``_bwd`` at kv = 77."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn(1, 128, 320, generator=gen, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, 77, 320, generator=gen, device=cuda).bfloat16() for _ in range(2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (pa.packed_flash_attention.launches, pa.packed_attention_forward_lse.launches,
              pa.packed_attention_backward.launches, pa.PackedFlashAttention.fallbacks)
    out = pa.packed_flash_attention(*leaves, 5)
    out.backward(do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = pa.packed_attention_reference(*ref, 5)
    ref_out.backward(do)
    torch.cuda.synchronize()
    assert (pa.packed_flash_attention.launches, pa.packed_attention_forward_lse.launches,
            pa.packed_attention_backward.launches, pa.PackedFlashAttention.fallbacks) == (
        counts[0] + 1, counts[1], counts[2], counts[3] + 1)
    assert (out.float() - ref_out.float()).abs().max().item() <= 1e-2
    for x, y in zip(leaves, ref):
        assert _rel_err(x.grad, y.grad) <= GRAD_REL_TOL


@pytest.mark.cuda
def test_wide_plans_match_the_sources_shared_memory(cuda):
    lib, blib, flib = pa._library(), pa._bwd_library(), fa._library()
    for d in (264, 320, 640, 1024, 4096):
        plan = pa.forward_plan(1, 4096, 4096, 1, d)
        assert lib.packed_attention_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                               d) == plan.smem_bytes
        plan = fa.plan(1, 1000, 77, 2, d)
        assert flib.flash_attention_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                               d) == plan.smem_bytes
        bp = pa.backward_plan(1, 64, 64, 1, d)
        assert [blib.packed_attention_bwd_smem_bytes(x, d) for x in (0, 1, 2)] == [
            bp.dq_smem_bytes, bp.dkdv_smem_bytes, bp.dv_smem_bytes]
        plan = pa._plan_for(1, 4096, 4096, 1, d, dtype=torch.float32)
        assert lib.packed_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                   d) == plan.smem_bytes
        plan = fa._plan_for(1, 1000, 77, 2, d, dtype=torch.float32)
        assert flib.flash_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                   d) == plan.smem_bytes
        bp = pa.backward_plan(1, 64, 64, 1, d, dtype=torch.float32)
        assert [blib.packed_attention_bwd_f32_smem_bytes(x, d) for x in (0, 1, 2)] == [
            bp.dq_smem_bytes, bp.dkdv_smem_bytes, bp.dv_smem_bytes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [264, 320, 384, 640, 1024])
def test_wide_backward_matches_plain_version_and_repeats(cuda, no_tf32, dtype, d):
    """B2b past four atoms (dq, dV and dK a launch each, two warpgroups
    sharing S and dP; rows resident up to six atoms in bf16; 1024 in two
    chunks): Sq != Sk so that both kernels walk their own tile count, against
    the plain version (bf16 2e-2, f32 1e-4 of max |grad|) and two calls the
    same bits."""
    b, sq, sk, h = 1, 192, 320, 2 if d <= 640 else 1
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    q, do = (torch.randn(b, sq, h * d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, sk, h * d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    o, lse = pa.packed_attention_lse_reference(q, k, v, h)
    o = o.to(dtype).contiguous()
    got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
    want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    tol = F32_TOL if dtype == torch.float32 else GRAD_REL_TOL
    assert max(_rel_err(x, y) for x, y in zip(got, want)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,h", [(1, 256, 320, 1), (2, 192, 384, 2), (1, 1024, 640, 1),
                                     (2, 256, 640, 2)])
def test_wide_forward_every_key_split_matches_plain_version(cuda, monkeypatch, b, s, d, h):
    """The wide forwards (paired at d = 320 and 384, the latter over an odd
    number of query tiles, streaming at 640) at every key split a launch
    takes (1 to four, a key tile each at least): B1 and B2a against the
    plain version, B2a's output B1's and two calls the same bits at each
    split."""
    q, k, v = _bf16_inputs(cuda, b, s, h * d, seed=d + s, n=3)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    plan = pa.forward_plan(b, s, s, h, d)
    assert plan.nwg == (2 if d <= 384 else 1)
    for splits in range(1, min(plan.kv_tiles, fa.MAX_SPLITS) + 1):
        p = dataclasses.replace(plan, splits=splits,
                                grid=(plan.grid[0] // plan.splits * splits, *plan.grid[1:]))
        monkeypatch.setattr(pa, "_plan_for", lambda *a, p=p, **kw: p)
        o1 = pa.packed_flash_attention(q, k, v, h)
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        again = pa.packed_flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1.float(), o_ref.float(), atol=1e-2, rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
        assert torch.equal(o, o1) and torch.equal(again, o1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_forward_past_1024_columns_streams_and_matches(cuda, no_tf32, dtype):
    """Past 1024 columns B1, B2a and B3 run the streaming wide kernels (f32:
    more chunks of two atoms than one cluster takes): d = 1088 (17 atoms,
    five chunks of four)."""
    b, s, h, d = 1, 256, 1, 1088
    plan = pa._plan_for(b, s, s, h, d, dtype=dtype)
    assert plan.nwg == 1 and plan.chunks == 5 and plan.cluster == plan.splits
    gen = torch.Generator(device=cuda).manual_seed(1088)
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device=cuda).to(dtype) for _ in range(3))
    o1 = pa.packed_flash_attention(q, k, v, h)
    o, lse = pa.packed_attention_forward_lse(q, k, v, h)
    o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
    q4, k4, v4 = (x.view(b, s, h, d) for x in (q, k, v))
    o3 = fa.flash_attention(q4, k4, v4)
    torch.cuda.synchronize()
    tol, lse_tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (1e-2, LSE_ATOL)
    assert torch.equal(o, o1)
    assert (o1.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= lse_tol
    assert (o3.float() - fa.flash_attention_reference(q4, k4, v4).float()).abs().max().item() <= tol
