"""The port's flash attention (B3): its plain version against the JAX Pallas
kernel (interpret mode on the CPU), its autograd against the JAX custom VJP,
and the ``"pallas"`` routing of the attention module. The CUDA kernel itself
is tested in test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.kernels.flash_attention import flash_attention as jax_flash
from genima_tpu.nn import layers as jl

from genima_torch.kernels import _build
from genima_torch.kernels import flash_attention as fa
from genima_torch.nn import layers as tl
from genima_torch.weights.from_jax import load_from_jax
from genima_torch.weights.init import build_module


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk))


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (64, 64, 2, 64),    # self-attention
        (100, 77, 3, 64),   # cross-attention with kv padding (77 -> block)
        (33, 16, 1, 64),    # ragged q padding
    ],
)
def test_plain_version_matches_pallas_kernel(sq, sk, h, d):
    q, k, v = _qkv(2, sq, sk, h, d, seed=sq + sk)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=32)
    got = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gradients_match_jax_custom_vjp():
    """The port's Function recomputes its backward through the plain
    version, as the JAX kernel's VJP recomputes through XLA."""
    q, k, v = _qkv(1, 32, 24, 2, 64, seed=1)

    def jax_loss(q, k, v):
        return (jax_flash(q, k, v, 16, 16) ** 2).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-4)


def test_numerical_stability_large_logits():
    """Max subtraction keeps exp() finite for large score magnitudes."""
    q = torch.full((1, 32, 1, 64), 8.0)
    out = fa.flash_attention_reference(q, q, torch.ones(1, 32, 1, 64))
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)


def test_cpu_call_never_touches_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = fa.flash_attention.launches
    q, k, v = map(torch.from_numpy, _qkv(1, 40, 77, 2, 64, seed=2))
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("backend", ["pallas", "pallas_self"])
@pytest.mark.parametrize("cross", [None, 48])
def test_attention_module_matches_jax(backend, cross):
    """Under 'pallas' both packages send self- and cross-attention to their
    flash kernel; under 'pallas_self' cross-attention takes the library
    attention."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 128).astype(np.float32)
    ctx = rng.randn(2, 77, cross).astype(np.float32) if cross else None
    jm = jl.Attention(128, 2, cross_attention_dim=cross, backend=backend)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    p = fast_init(jm, jax.random.key(0), *args, seed=3)["params"]
    tm = build_module(lambda: tl.Attention(128, 2, cross, backend), torch.device("cpu"),
                      torch.float32)
    load_from_jax(tm, jax.tree_util.tree_map(np.asarray, p), "diffusers_unet")
    targs = (torch.from_numpy(x),) + ((torch.from_numpy(ctx),) if cross else ())
    np.testing.assert_allclose(tm(*targs).detach().numpy(),
                               np.asarray(jm.apply({"params": p}, *args)), atol=1e-4)


def test_resolve_backend_matches_jax():
    for spec in ("fused", "xla", "pallas", "pallas_self", "pallas+w8", "pallas_self+w8",
                 "fused+w8", "xla+w8"):
        assert tl.split_backend(spec) == jl.split_backend(spec)
        for cross in (False, True):
            assert tl.resolve_backend(spec, cross) == jl.resolve_backend(spec, cross), spec
    with pytest.raises(ValueError, match="backend"):
        tl.split_backend("pallas+w4")
