"""Flash attention (non-causal) on (B, S, H, D) for the ``"pallas"`` backends.

Replaces the TPU kernel of ``genima_tpu/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_forward`` -> ``_flash_kernel``) and its
custom VJP (``_flash_fwd`` / ``_flash_bwd``) as ``FlashAttention``, a
``torch.autograd.Function`` whose backward recomputes through the plain
version's autograd, as ``_flash_bwd`` recomputes through XLA.

Under ``backend="pallas"`` every UNet and ControlNet attention comes here,
self-attention over 4096/1024/256/64 tokens and cross-attention over the 77
prompt tokens; under ``"pallas_self"`` only self-attention does.

* CUDA: ``csrc/flash_attention.cu``, B1's FlashAttention-2 forward with a
  ragged edge: any Sq and Sk, keys past Sk zero-filled and masked to -1e30,
  query rows past Sq never stored. It reads (B, S, H, 64) in place with row
  stride H*64; the JAX wrapper's transposes to (B*H, S, D) are a TPU tiling
  artifact and are not ported. Takes bf16 and head_dim 64; anything else
  raises. Bound: tensor-core operations for long self-attention, bytes for
  cross-attention over 77 keys.
* CPU: ``flash_attention_reference``, the same arithmetic in plain PyTorch
  (f32 scores, P rounded to v's dtype before P V). The wrapper takes it only
  for tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from genima_torch.kernels import _build

HEAD_DIM = 64


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, Sq, H, D), (B, Sk, H, D) x2 -> (B, Sq, H, D) in q's
    dtype. Explicit matmul and softmax per head in f32; P rounded to v's
    dtype before P V, as the TPU kernel does."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).float(), vh) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(q, k, v) -> None:
    b, _, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on CUDA, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape or k.shape[1] < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d != HEAD_DIM:
        raise ValueError(f"head_dim {d} != {HEAD_DIM}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b, sq, k.shape[1], h, stream)
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(b, sq, k.shape[1], h * q.shape[-1])] += 1
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: {lib.flash_attention_error_string(rc).decode()} ({rc})")
    return out


class FlashAttention(torch.autograd.Function):
    """The TPU package's ``custom_vjp``: the kernel forward; the backward
    recomputes through the plain version's autograd (exact gradients; this
    backend serves inference)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = flash_attention_reference(*qkv)
            return torch.autograd.grad(out, qkv, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T / sqrt(D)) V per head on (B, S, H, D) tensors,
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return _forward(q, k, v)


# kernel launches since the last reset, in all and by (B, Sq, Sk, C)
flash_attention.launches = 0
flash_attention.launches_by_shape = collections.Counter()
