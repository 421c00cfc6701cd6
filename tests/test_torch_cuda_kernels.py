"""The port's hand-written CUDA kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere. Imports nothing of JAX, so
it runs on a GPU host without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

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
    with pytest.raises(ValueError, match="multiple of 64"):
        pa.packed_flash_attention(q[:, :100], q[:, :100], q[:, :100], 2)
    with pytest.raises(ValueError, match="bfloat16"):
        pa.packed_flash_attention(q.float(), q.float(), q.float(), 2)


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
