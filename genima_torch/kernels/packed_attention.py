"""Packed-layout flash attention for the SD UNet / ControlNet self-attention.

Replaces the TPU kernels of ``genima_tpu/kernels/packed_attention.py``:

* B1, the forward (``_forward`` -> ``_packed_kernel`` and
  ``_forward_streaming`` -> ``_streaming_kernel``);
* B2a, the forward that also emits L = m + log(l) per (row, head)
  (``_forward_with_lse`` -> ``_packed_kernel_lse``);
* B2b, the flash backward (``_flash_backward`` -> ``_bwd_kernel``);
* their custom VJP (``_fwd`` / ``_bwd``) as ``PackedFlashAttention``, a
  ``torch.autograd.Function``.

``packed_flash_attention(q, k, v, num_heads)`` computes
``softmax(Q_h K_h^T / sqrt(d)) V_h`` for every head on packed
``(B, S, heads * d)`` tensors, exactly as the ``to_q``/``to_k``/``to_v``
linears emit them: no ``(S, H, D) -> (H, S, D)`` transposes at the kernel
boundary, which is why the kernels exist. When q, k or v requires grad it
goes through ``PackedFlashAttention`` (B2a forward, B2b backward); otherwise
it runs B1 and records nothing for autograd.

* CUDA: ``csrc/packed_attention.cu`` (B1 and B2a: the warp-specialised
  FlashAttention-3-style forward for ``sm_90a`` that B3 shares,
  ``csrc/attention_fwd_hopper.cuh``, instantiated without and with the L
  store. A producer warp or warpgroup TMA-loads the block's Q tile and
  streams K/V tiles through an mbarrier ring over 3-D (C, S, B) maps at
  column offset ``h * 64``; one to three consumer warpgroups of 64 query
  rows run S = Q K^T and O += P V on wgmma with the online softmax in f32
  registers;
  ``forward_plan`` picks the warpgroups, the key tile and the ring depth,
  the same for B1 and B2a at a shape, so B2a's output is B1's bit for bit)
  and ``csrc/packed_attention_bwd.cu`` (B2b: a dq kernel and a dk/dv kernel,
  no atomics, so repeated calls give the same bits; each a warp-specialised
  Hopper kernel, a producer warpgroup streaming 64-row tiles by TMA through
  an mbarrier ring to two consumer warpgroups on wgmma; ``backward_plan``
  gives its grids and shared memory). Bound: the forward does 4*S^2*C
  flops and the backward 10*S^2*C on ~8*S*C and ~16*S*C bytes, so at the
  SD levels tensor-core operations bound both; the design keeps scores out
  of device memory.
  Takes bf16, head_dim 64, and ``Sq``, ``Sk`` multiples of 64 up to 4096;
  anything else raises.
* CPU: ``packed_attention_reference``, ``packed_attention_lse_reference`` and
  ``packed_attention_backward_reference``, the same arithmetic in plain
  PyTorch (bf16 roundings included). The wrappers take them only for
  tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import torch

from genima_torch.kernels import _build
from genima_torch.kernels import flash_attention as fa

HEAD_DIM = 64
BLOCK = 64  # Sq and Sk are multiples of this: the backward's 64-row tiles
MAX_SEQ = 4096
# B1/B2a: (consumer warpgroups of 64 query rows, keys a K/V tile), the
# instantiations of packed_attention.cu: those ``forward_plan`` picks at some
# shape (Sk is a multiple of 64, so B3's 80-key tile for the 77 prompt
# tokens is not built; 64-key tiles with two or three warpgroups never beat
# 128-key ones, tune_kernels packed)
FORWARD_TILES = ((1, 64), (1, 128), (2, 128), (3, 128))
# B2b: query rows (dq kernel) or keys (dk/dv kernel) a block, two consumer
# warpgroups of 64, and the depth of each kernel's TMA ring
BWD_BLOCK_ROWS = 128
BWD_STAGES = 4
BWD_THREADS = 384  # two consumer warpgroups and the producer warpgroup
SMS = 132  # streaming multiprocessors of an H100 SXM
REGISTERS_SM = 65536


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """B2b's two launches for a (B, Sq, Sk, heads) call: the dq kernel's
    grid walks query blocks, the dk/dv kernel's key blocks, each over
    (blocks, heads, batch); shared memory mirrors
    ``packed_attention_bwd_smem_bytes`` in the source."""

    dq_grid: tuple[int, int, int]
    dkdv_grid: tuple[int, int, int]
    dq_smem_bytes: int
    dkdv_smem_bytes: int
    why_short: str  # why a grid is under one wave ("" if neither is)

    @property
    def max_registers(self) -> int:
        """ptxas's cap from the launch bounds (one block an SM): 168, from
        which setmaxnreg moves the producer to 24 and the consumers to 240."""
        return min(255, REGISTERS_SM // BWD_THREADS // 8 * 8)


def backward_plan(b: int, sq: int, sk: int, h: int, sms: int = SMS) -> BackwardPlan:
    """The fixed tiling of B2b (128-row blocks, a 4-stage ring of 64-row
    tiles) at one shape; raises for a shape the kernels do not take."""
    _check_shape(b, sq, sk, h)
    ring = BWD_STAGES * 2 * BLOCK * HEAD_DIM * 2  # a Q/dO or K/V pair of tiles a stage
    dq = (-(-sq // BWD_BLOCK_ROWS), h, b)
    dkdv = (-(-sk // BWD_BLOCK_ROWS), h, b)
    short = [f"{name}: {g[0]} blocks of {BWD_BLOCK_ROWS} {what} x {h} heads x batch {b}"
             for name, g, what in (("dq", dq, "queries"), ("dk/dv", dkdv, "keys"))
             if g[0] * h * b < sms]
    return BackwardPlan(
        dq_grid=dq, dkdv_grid=dkdv, dq_smem_bytes=1024 + ring + 16 * BWD_STAGES,
        # + each stage's 64 values of L * log2(e) and Drow
        dkdv_smem_bytes=1024 + ring + BWD_STAGES * 2 * BLOCK * 4 + 16 * BWD_STAGES,
        why_short="; ".join(short))


def _check_seq(sq: int, sk: int) -> None:
    for name, s in (("Sq", sq), ("Sk", sk)):
        if s % BLOCK or not 0 < s <= MAX_SEQ:
            raise ValueError(f"{name}={s} must be a multiple of {BLOCK} up to {MAX_SEQ}")


def _check_shape(b: int, sq: int, sk: int, h: int) -> None:
    """Raises for a (B, Sq, Sk, heads) call the kernels do not take."""
    if min(b, h) < 1:
        raise ValueError(f"empty attention: B={b}, heads={h}")
    _check_seq(sq, sk)


@functools.lru_cache(maxsize=None)
def forward_plan(b: int, sq: int, sk: int, h: int, sms: int = SMS) -> fa.Plan:
    """Consumer warpgroups, key tile and ring depth of B1 and B2a (one plan
    for both: the key tile sets the order of the online-softmax updates) for
    a (B, Sq, Sk, heads) call, by the rules ``python -m genima_torch.tune_kernels
    packed`` chose:

    * a key loop of ``fa.LONG_KEY_LOOP`` 128-key tiles or more: two or
      three consumer warpgroups (128 or 192 query rows a block, sharing
      each K/V stage), as B3's ``fa.long_loop_warpgroups`` picks them;
    * a shorter one: one warpgroup, on 128-key tiles while the grid is at
      most one block an SM (1x256 x 20 heads: 80 blocks), else on 64-key
      tiles, whose block takes at most 136 registers so that three share
      an SM (4x256 x 20 heads: 320 blocks in one wave, 0.0094 ms against
      0.0111 on 128-key tiles); 64-key tiles also when Sk is 64;
    * ring: as deep as the K/V tiles need, at most four stages.

    Raises for a shape the kernel does not take.
    """
    if -(-sk // 128) >= fa.LONG_KEY_LOOP:
        nwg, bn = fa.long_loop_warpgroups(b, sq, h, sms), 128
    else:
        nwg, bn = 1, 64 if sk <= 64 or -(-sq // 64) * h * b > sms else 128
    return make_forward_plan(b, sq, sk, h, nwg, bn, sms=sms)


def make_forward_plan(b: int, sq: int, sk: int, h: int, nwg: int, bn: int,
                      stages: int | None = None, sms: int = SMS) -> fa.Plan:
    """B1/B2a's launch for a chosen tile; the ring depth as ``forward_plan``
    derives it unless given. The shared memory mirrors
    ``packed_attention_smem_bytes`` in the source."""
    _check_shape(b, sq, sk, h)
    return fa.make_plan(b, sq, sk, h, nwg, bn, stages, sms=sms, tiles=FORWARD_TILES)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, heads*d) -> (B, heads, S, d) in f32."""
    b, s, c = x.shape
    return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2).float()


def _packed(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, heads, S, d) -> (B, S, heads*d) in ``dtype``."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def packed_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2a: explicit matmul and softmax per head, f32
    scores, P rounded to v's dtype before P V (as the TPU kernel does).
    Returns o in q's dtype and L = m + log(l) as (B, Sq, heads) f32."""
    d = q.shape[-1] // num_heads
    s = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2))
    s = s * (1.0 / math.sqrt(d))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, num_heads)) / l
    lse = (m + torch.log(l)).squeeze(-1).transpose(1, 2).contiguous()
    return _packed(o, q.dtype), lse


def packed_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain version of B1: the output of ``packed_attention_lse_reference``."""
    return packed_attention_lse_reference(q, k, v, num_heads)[0]


def packed_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of B2b, the arithmetic of ``_bwd_kernel``: P rebuilt
    from L in f32 and rounded to q's dtype before P^T dO; dS rounded to q's
    dtype before dS K and dS^T Q; Drow = rowsum(dO * O) of the dO cast to
    q's dtype. Returns dq, dk, dv in q's dtype."""
    dtype = q.dtype
    d = q.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, oh = (_heads(x, num_heads) for x in (q, k, v, o))
    doh = _heads(do.to(dtype), num_heads)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float().transpose(1, 2).unsqueeze(-1))
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    drow = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - drow) * scale).to(dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return _packed(dq, dtype), _packed(dk, dtype), _packed(dv, dtype)


def kernel_tiles(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernels' 64-row tiles cover Sq and Sk (multiples of 64 up
    to 4096). The backward takes a shape only then; otherwise autograd
    recomputes through the plain version, as the TPU package does where
    ``_bwd_kernel_applicable`` is false (kv=77 cross-attention)."""
    return all(s % BLOCK == 0 and 0 < s <= MAX_SEQ for s in (q.shape[1], k.shape[1]))


def _check_cuda_inputs(q, k, v, num_heads) -> None:
    b, sq, c = q.shape
    sk = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on CUDA, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != (b, sk, c) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"channels {c} != {num_heads} heads x {HEAD_DIM}")
    _check_seq(sq, sk)


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _plan_for(b: int, sq: int, sk: int, h: int) -> fa.Plan:
    """The plan a B1 or B2a call launches (``tune_kernels`` and the card
    tests swap in others)."""
    return forward_plan(b, sq, sk, h)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    # pointers, then (B, Sq, Sk, heads) and the plan's (nwg, bn, stages), then the stream
    lib.packed_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_fwd_lse.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_fwd.restype = lib.packed_attention_fwd_lse.restype = ctypes.c_int
    lib.packed_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_attention_smem_bytes.restype = ctypes.c_int
    lib.packed_attention_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("packed_attention_bwd")
    lib.packed_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_bwd.restype = ctypes.c_int
    lib.packed_attention_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.packed_attention_bwd_smem_bytes.restype = ctypes.c_int
    lib.packed_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(rc).decode()} ({rc})")


def _count(fn, q: torch.Tensor, k: torch.Tensor) -> None:
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
        fn.launches += 1
        fn.launches_by_shape[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])] += 1


def _launch_forward(q, k, v, num_heads, with_lse: bool):
    _check_cuda_inputs(q, k, v, num_heads)
    b, sq, _ = q.shape
    p = _plan_for(b, sq, k.shape[1], num_heads)
    out = torch.empty_like(q)
    lse = torch.empty(b, sq, num_heads, device=q.device, dtype=torch.float32) if with_lse else None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        dims = (b, sq, k.shape[1], num_heads, p.nwg, p.bn, p.stages, stream)
        if with_lse:
            rc = lib.packed_attention_fwd_lse(*args, lse.data_ptr(), *dims)
        else:
            rc = lib.packed_attention_fwd(*args, *dims)
    _count(packed_attention_forward_lse if with_lse else packed_flash_attention, q, k)
    _raise_on(rc, "packed_attention_fwd" + ("_lse" if with_lse else ""),
              lib.packed_attention_error_string)
    return (out, lse) if with_lse else out


def _forward(q, k, v, num_heads) -> torch.Tensor:
    """B1: the kernel on CUDA, the plain version on the CPU."""
    if _device(q) == "cpu":
        return packed_attention_reference(q, k, v, num_heads)
    return _launch_forward(q, k, v, num_heads, with_lse=False)


def packed_attention_forward_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """B2a: attention output and its (B, Sq, heads) f32 log-sum-exp."""
    if _device(q) == "cpu":
        return packed_attention_lse_reference(q, k, v, num_heads)
    return _launch_forward(q, k, v, num_heads, with_lse=True)


def packed_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, num_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2b: dq, dk, dv from the forward's o and lse and the output grad."""
    do = do.to(q.dtype).contiguous()
    if _device(q) == "cpu":
        return packed_attention_backward_reference(q, k, v, o, lse, do, num_heads)
    _check_cuda_inputs(q, k, v, num_heads)
    for name, x, dtype in (("o", o, q.dtype), ("do", do, q.dtype), ("lse", lse, torch.float32)):
        if x.device != q.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {q.device}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (*q.shape[:2], num_heads):
        raise ValueError(f"shapes o {tuple(o.shape)} do {tuple(do.shape)} lse {tuple(lse.shape)}")
    b, sq, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # L * log2(e) and rowsum(dO * O) as (B, heads, Sq), written by the first
    # kernel for the second
    delta = torch.empty(2, b, num_heads, sq, device=q.device, dtype=torch.float32)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.packed_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], num_heads, stream,
        )
    _count(packed_attention_backward, q, k)
    _raise_on(rc, "packed_attention_bwd", lib.packed_attention_bwd_error_string)
    return dq, dk, dv


class PackedFlashAttention(torch.autograd.Function):
    """Counterpart of the TPU package's ``custom_vjp`` (``_fwd``/``_bwd``):
    the forward runs B2a and saves q, k, v, o and L; the backward runs B2b.
    A shape the kernels cannot tile (``kernel_tiles`` false) runs the plain
    forward and recomputes its gradient through the plain version's
    autograd, counted in ``PackedFlashAttention.fallbacks``."""

    fallbacks = 0  # backward passes that took the plain recompute

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.fallback = not kernel_tiles(q, k)
        if ctx.fallback:
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v, num_heads)
        o, lse = packed_attention_forward_lse(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.fallback:
            PackedFlashAttention.fallbacks += 1
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_() for x in ctx.saved_tensors]
                out = packed_attention_reference(*qkv, ctx.num_heads)
                grads = torch.autograd.grad(out, qkv, do)
            return (*grads, None)
        q, k, v, o, lse = ctx.saved_tensors
        return (*packed_attention_backward(q, k, v, o, lse, do, ctx.num_heads), None)


def packed_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Multi-head attention on packed (B, S, heads*head_dim) tensors,
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return PackedFlashAttention.apply(q, k, v, num_heads)
    return _forward(q, k, v, num_heads)


# kernel launches since the last reset, in all and by (B, Sq, Sk, C):
# B1 on packed_flash_attention, B2a and B2b on their own wrappers
for _fn in (packed_flash_attention, packed_attention_forward_lse, packed_attention_backward):
    _fn.launches = 0
    _fn.launches_by_shape = collections.Counter()
del _fn
