"""The training half of the port's packed flash attention (B2) on the CPU:
the LSE forward and the backward's plain versions against the JAX Pallas
kernels in interpret mode, and ``PackedFlashAttention``'s autograd wiring
against ``jax.grad`` of the JAX custom VJP. The CUDA kernels themselves are
held to these plain versions in test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.kernels.packed_attention import (
    _flash_backward,
    _forward_with_lse,
    packed_flash_attention as jax_packed,
)

from genima_torch.kernels import _build
from genima_torch.kernels import packed_attention as pa

O_ATOL = 1e-5  # o and L, f32
GRAD_ATOL = 1e-4  # dq, dk, dv, f32


def _inputs(b, sq, sk, c, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, c).astype(np.float32) for s in (sq, sk, sk, sq)[:n]]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,sq,sk,c,h", [
    (1, 256, 256, 128, 2),  # head_dim 64, the CUDA kernel's geometry
    (2, 128, 128, 320, 5),
    (1, 128, 256, 64, 1),  # more keys than queries
])
def test_lse_forward_matches_pallas(b, sq, sk, c, h):
    q, k, v = _inputs(b, sq, sk, c, seed=sq + c, n=3)
    want_o, want_l = _forward_with_lse(*map(jnp.asarray, (q, k, v)), h, 128, True)
    got_o, got_l = pa.packed_attention_forward_lse(*_t(q, k, v), h)
    assert got_l.shape == (b, sq, h) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=O_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=O_ATOL)


@pytest.mark.parametrize("b,sq,sk,c,h,block_k", [
    (1, 128, 128, 128, 2, 128),  # one key block
    (2, 256, 256, 320, 5, 128),  # several key blocks: dq accumulated across them
    (1, 128, 256, 128, 2, 64),  # four key blocks, kv longer than q
])
def test_backward_matches_pallas(b, sq, sk, c, h, block_k):
    q, k, v, do = _inputs(b, sq, sk, c, seed=7 * sq + c)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _forward_with_lse(jq, jk, jv, h, 128, True)
    want = _flash_backward(jq, jk, jv, o, lse, jdo, h, True, block_k=block_k)
    got = pa.packed_attention_backward(
        *_t(q, k, v, np.array(o), np.array(lse), do), h
    )
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL, err_msg=name)


def test_backward_bf16_roundings_match_pallas():
    """In bf16 the plain backward rounds P and dS where ``_bwd_kernel``
    does: the two agree to bf16 output rounding (2^-8 of max |grad|)."""
    q, k, v, do = _inputs(1, 256, 256, 128, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = _forward_with_lse(jq, jk, jv, 2, 128, True)
    want = _flash_backward(jq, jk, jv, o, lse, jdo, 2, True)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    to = torch.from_numpy(np.asarray(o, np.float32)).bfloat16()
    got = pa.packed_attention_backward(tq, tk, tv, to, torch.from_numpy(np.array(lse)), tdo, 2)
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        y = np.asarray(y, np.float32)
        err = np.abs(x.float().numpy() - y).max() / np.abs(y).max()
        assert err <= 2 ** -8, err


def _grads_port(q, k, v, h):
    leaves = [x.clone().requires_grad_() for x in _t(q, k, v)]
    out = pa.packed_flash_attention(*leaves, h)
    (out ** 2).sum().backward()
    return out, [x.grad for x in leaves]


def _grads_jax(q, k, v, h):
    def loss(q, k, v):
        return (jax_packed(q, k, v, h) ** 2).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("b,sq,sk,c,h", [
    (1, 128, 128, 320, 5),  # mirrors test_packed_attention.py::test_grads_match_xla
    (2, 256, 256, 320, 5),  # ::test_flash_backward_multi_kblock
])
def test_autograd_matches_jax_custom_vjp(b, sq, sk, c, h):
    q, k, v = _inputs(b, sq, sk, c, seed=11 + sq, n=3)
    counts = (pa.packed_attention_forward_lse.launches, pa.PackedFlashAttention.fallbacks)
    out, grads = _grads_port(q, k, v, h)
    assert type(out.grad_fn).__name__ == "PackedFlashAttentionBackward"
    for x, y in zip(grads, _grads_jax(q, k, v, h)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=2e-4)
    # the kernel path, with no fallback and (on the CPU) no launch
    assert (pa.packed_attention_forward_lse.launches, pa.PackedFlashAttention.fallbacks) == counts


def test_kv77_falls_back_to_plain_recompute():
    """kv=77 (cross-attention) cannot tile the backward: the gradient is
    recomputed through the plain version, counted as a fallback (mirrors
    test_packed_attention.py::test_flash_backward_fallback_cross)."""
    q, k, v = _inputs(1, 128, 77, 320, seed=12, n=3)
    before = pa.PackedFlashAttention.fallbacks
    _, grads = _grads_port(q, k, v, 5)
    assert pa.PackedFlashAttention.fallbacks == before + 1
    for x, y in zip(grads, _grads_jax(q, k, v, 5)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL)


def test_no_grad_takes_the_forward_alone():
    """Without requires_grad the call records nothing for autograd (B1)."""
    q, k, v = _t(*_inputs(1, 256, 256, 128, seed=5, n=3))
    out = pa.packed_flash_attention(q, k, v, 2)
    assert out.grad_fn is None
    leaves = [x.requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert pa.packed_flash_attention(*leaves, 2).grad_fn is None
    torch.testing.assert_close(out, pa.packed_attention_reference(q, k, v, 2), rtol=0, atol=0)


def test_cpu_training_never_touches_the_kernels(monkeypatch):
    """On the CPU the Function runs the plain versions: no library is built
    or loaded and every launch counter stays where it was."""
    def no_build(name):
        raise AssertionError("a CPU call must not build or load a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    fns = (pa.packed_flash_attention, pa.packed_attention_forward_lse, pa.packed_attention_backward)
    before = [f.launches for f in fns]
    _grads_port(*_inputs(2, 256, 256, 128, seed=6, n=3), 2)
    assert [f.launches for f in fns] == before
    assert not any(f.launches_by_shape for f in fns)


@pytest.mark.parametrize("sq,sk,tiles", [
    (256, 256, True), (4096, 64, True), (128, 77, False), (96, 128, False), (16384, 9216, True),
])
def test_kernel_tiles(sq, sk, tiles):
    assert pa.kernel_tiles(torch.empty(1, sq, 64), torch.empty(1, sk, 64)) == tiles


def test_backward_on_other_devices_raises():
    """Neither CPU nor CUDA: the backward wrapper refuses before any build."""
    x = torch.empty(1, 256, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        pa.packed_attention_backward(x, x, x, x, torch.empty(1, 256, 2), x, 2)
