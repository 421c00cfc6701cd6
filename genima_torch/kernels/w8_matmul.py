"""Weight-only int8 matmul: int8 weights widened to bf16 inside the kernel.

Replaces the TPU kernel of ``genima_tpu/kernels/w8_matmul.py``
(``_w8_matmul_2d`` -> ``_kernel``, and ``w8_matmul_interpret``, the same
kernel body). Per-output-column symmetric quantization,
``w ~= w_q * scale``, so ``x @ w ~= (x @ w_q) * scale``: the scale factors
out of the contraction and is applied once to the f32 accumulator.

Layout: ``w_q`` is ``(N, K)`` int8, one row per output column, as
``nn.Linear.weight`` stores a weight (the JAX kernel takes ``(K, N)``;
``weights.from_jax`` transposes ``kernel_q`` on load). That is the column
layout the tensor cores' B operand wants, so two neighbouring K values of a
column are one 16-bit load.

* CUDA: ``csrc/w8_matmul.cu``, a tiled mma.sync GEMM that keeps the weight
  int8 in device and shared memory and widens it in registers, K walked in
  32-wide tiles, ragged M and N masked. Takes bf16 x, K % 16 == 0 and
  N % 8 == 0; anything else raises. Bound: weight bytes at M <= 256, tensor
  cores at M = 4096.
* CPU: ``w8_matmul_reference``, the JAX fallback's arithmetic (x rounded to
  bf16, exact int8 values, f32 accumulate, ``* scale``, cast to x's dtype).
  The wrapper takes it only for tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from genima_torch.kernels import _build


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 of an ``(N, K)`` weight: returns
    ``w_q`` int8 ``(N, K)`` and ``scale`` f32 ``(N,)`` with
    ``weight ~= w_q * scale[:, None]``. ``torch.round`` rounds half to even,
    as ``jnp.round`` does, so the two packages agree bit for bit."""
    w32 = weight.float()
    scale = (w32.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    w_q = torch.round(w32 / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def w8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., K) x, (N, K) int8 w_q, (N,) f32 scale ->
    (..., N) in x's dtype."""
    acc = torch.matmul(x.to(torch.bfloat16).float(), w_q.float().t())
    return (acc * scale.float()).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("w8_matmul")
    lib.w8_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.w8_matmul.restype = ctypes.c_int
    lib.w8_matmul_error_string.argtypes = [ctypes.c_int]
    lib.w8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(x2, w_q, scale) -> None:
    m, k = x2.shape
    n = w_q.shape[0]
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16 on CUDA, got {x2.dtype}")
    if w_q.dtype != torch.int8 or w_q.shape != (n, k):
        raise ValueError(f"w_q must be int8 (N, {k}), got {w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"scale must be float32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("x", x2), ("w_q", w_q), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k % 16 or n % 8:
        raise ValueError(f"K={k} must be a multiple of 16 and N={n} of 8")


def _forward(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return w8_matmul_reference(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()  # proj_in's tokens are a permuted NCHW view
    _check_cuda_inputs(x2, w_q, scale)
    m, n = x2.shape[0], w_q.shape[0]
    out = torch.empty(m, n, device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.w8_matmul(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           m, n, k, stream)
    w8_matmul.launches += 1
    w8_matmul.launches_by_shape[(m, k, n)] += 1
    if rc != 0:
        raise RuntimeError(f"w8_matmul launch failed: {lib.w8_matmul_error_string(rc).decode()} ({rc})")
    return out.reshape(*lead, n)


class W8Matmul(torch.autograd.Function):
    """The kernel forward; the backward recomputes dx through the plain
    version's autograd (the int8 weights are not trained). Without it a
    CUDA output would carry no ``grad_fn`` and cut the gradient silently."""

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(x, w_q, scale)
        return _forward(x, w_q, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w_q, scale = ctx.saved_tensors
        with torch.enable_grad():
            leaf = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(w8_matmul_reference(leaf, w_q, scale), leaf, dy)
        return dx, None, None


def w8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ (w_q * scale[:, None]).T`` with in-kernel dequantisation:
    (..., K) x, (N, K) int8 w_q, (N,) f32 scale -> (..., N) in x's dtype,
    differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return W8Matmul.apply(x, w_q, scale)
    return _forward(x, w_q, scale)


# kernel launches since the last reset, in all and by (M, K, N)
w8_matmul.launches = 0
w8_matmul.launches_by_shape = collections.Counter()
