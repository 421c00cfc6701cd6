"""The port's packed flash attention: its plain version against the JAX
Pallas kernel (interpret mode on CPU), and the wrapper's routing and checks.
The CUDA kernel itself is tested in test_torch_cuda_kernels.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.kernels.packed_attention import packed_flash_attention as jax_packed

from genima_torch.kernels import _build
from genima_torch.kernels import packed_attention as pa

SHAPES = [
    # (batch, q_len, kv_len, channels, heads): the reference's test shapes
    (1, 512, 512, 320, 5),
    (2, 256, 256, 640, 10),
    (1, 64, 64, 1280, 20),
    (1, 128, 77, 320, 5),
    # head_dim 64 at two heads, the CUDA kernel's geometry
    (1, 256, 256, 128, 2),
]


def _qkv(b, sq, sk, c, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple(
        (rng.randn(b, s, c) * scale).astype(np.float32) for s in (sq, sk, sk)
    )


@pytest.mark.parametrize("b,sq,sk,c,h", SHAPES)
def test_plain_version_matches_pallas_kernel(b, sq, sk, c, h):
    q, k, v = _qkv(b, sq, sk, c, seed=b * sq + c)
    want = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = pa.packed_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_version_large_logits_finite():
    """Max subtraction keeps exp() finite for large score magnitudes."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 256, 320, seed=3, scale=30.0))
    out = pa.packed_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), 5)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_cpu_call_never_touches_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU call must not build or load the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = pa.packed_flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 256, 128, seed=4))
    out = pa.packed_flash_attention(q, k, v, 2)
    assert pa.packed_flash_attention.launches == before
    torch.testing.assert_close(out, pa.packed_attention_reference(q, k, v, 2), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty(1, 256, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        pa.packed_flash_attention(q, q, q, 2)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize(
    "q,k,num_heads,match",
    [
        (_bf16(1, 256, 128), _bf16(1, 256, 128), 2, None),
        (_bf16(1, 256, 128).float(), _bf16(1, 256, 128), 2, "bfloat16"),
        (_bf16(1, 256, 528), _bf16(1, 256, 528), 2, None),  # d 264: the wide kernels
        (_bf16(1, 96, 128), _bf16(1, 96, 128), 2, "multiple of 64"),
        (_bf16(1, 256, 128), _bf16(1, 77, 128), 2, "multiple of 64"),
        (_bf16(1, 9216, 64), _bf16(1, 9216, 64), 1, None),
        (_bf16(1, 256, 256)[:, :, :128], _bf16(1, 256, 128), 2, "contiguous"),
    ],
)
def test_cuda_input_checks(q, k, num_heads, match):
    """The checks the wrapper runs before every launch (they need no card)."""
    if match is None:
        pa._check_cuda_inputs(q, k, k, num_heads)
        return
    with pytest.raises(ValueError, match=match):
        pa._check_cuda_inputs(q, k, k, num_heads)


def test_module_imports_without_cuda_or_nvcc(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    code = (
        "import genima_torch.kernels.packed_attention as m, genima_torch.nn.layers;"
        "assert m.packed_flash_attention.launches == 0"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], env=env, cwd=root, check=True,
                   timeout=120)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("packed_attention")
    # the library name follows the source and the flags
    assert _build.library_path("packed_attention").name.startswith("libpacked_attention-")
