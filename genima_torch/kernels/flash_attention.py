"""Flash attention (non-causal) on (B, S, H, D) for the ``"pallas"`` backends.

Replaces the TPU kernel of ``genima_tpu/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_forward`` -> ``_flash_kernel``) and its
custom VJP (``_flash_fwd`` / ``_flash_bwd``) as ``FlashAttention``, a
``torch.autograd.Function`` whose backward recomputes through the plain
version's autograd, as ``_flash_bwd`` recomputes through XLA.

Under ``backend="pallas"`` every UNet and ControlNet attention comes here,
self-attention over 4096/1024/256/64 tokens and cross-attention over the 77
prompt tokens; under ``"pallas_self"`` only self-attention does.

* CUDA: ``csrc/flash_attention.cu``, instantiating the warp-specialised
  FlashAttention-3-style forward for Hopper that B1/B2a share
  (``csrc/attention_fwd_hopper.cuh``), with a ragged edge: a producer
  TMA-loads the block's Q tile and streams K/V tiles through an mbarrier
  ring (3-D maps, so rows past S are zero-filled within the batch); one to
  three consumer warpgroups of 64 query rows run S = Q K^T and O += P V on
  wgmma with the online softmax in registers, keys past Sk masked to -1e30
  in the last tile and query rows past Sq never stored. ``plan`` picks the
  consumer warpgroups, the key tile and the ring depth per shape. It reads
  (B, S, H, 64) in place with row stride H*64; the JAX wrapper's
  transposes to (B*H, S, D) are a TPU tiling artifact and are not ported.
  Takes bf16 and head_dim 64; anything else raises. Bound: tensor-core
  operations for long self-attention, bytes for cross-attention over 77
  keys.
* CPU: ``flash_attention_reference``, the same arithmetic in plain PyTorch
  (f32 scores, P rounded to v's dtype before P V). The wrapper takes it only
  for tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
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


SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_SM = 233472  # shared memory of an SM (228 KB; 1 KB of it reserved per block)
REGISTERS_SM = 65536
# (consumer warpgroups of 64 query rows, keys a K/V tile): the kernel's
# instantiations
TILES = ((1, 64), (1, 80), (1, 128), (2, 64), (2, 80), (2, 128), (3, 128))
MAX_STAGES = 4
LONG_KEY_LOOP = 4  # K/V tiles from which two or three consumer warpgroups pay
# time per 64 query rows of a three-warpgroup block against a two-warpgroup
# one, both one block an SM (tune_kernels packed, H100: 1x4096, 5 heads,
# 0.0515 ms in one wave of 192-row blocks against 0.0759 in two of 128)
THREE_WG_ROW_COST = 0.9


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: ``nwg`` consumer warpgroups (64 query rows each),
    ``bn`` keys a K/V tile, a ring of ``stages`` K/V stages."""

    nwg: int
    bn: int
    stages: int
    kv_tiles: int
    grid: tuple[int, int, int]  # (query tiles, heads, batch)
    smem_bytes: int
    why_short: str  # why the grid is under one wave ("" if it is not)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def rows(self) -> int:
        return 64 * self.nwg

    @property
    def threads(self) -> int:
        # + the producer: one warp beside one consumer warpgroup, else a
        # warpgroup (setmaxnreg moves registers by warpgroup)
        return 128 * self.nwg + (32 if self.nwg == 1 else 128)

    @property
    def blocks_per_sm(self) -> int:
        """The kernel's launch bounds: the one-warpgroup, 64-key block is
        held to 136 registers a thread so that three share an SM."""
        return 3 if (self.nwg, self.bn) == (1, 64) else 1

    @property
    def max_registers(self) -> int:
        """Registers a thread may hold at launch (ptxas's cap from the
        launch bounds; with setmaxnreg the consumers of a 384-thread block
        then take 240, those of a 512-thread block 160)."""
        return min(255, REGISTERS_SM // (self.threads * self.blocks_per_sm) // 8 * 8)


def smem_bytes(nwg: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one block: 1 KB of alignment slack, the Q
    tile, the K/V ring and the barriers. Mirrors ``fwd_smem_bytes`` in
    ``csrc/attention_fwd_hopper.cuh``, which ``flash_attention_smem_bytes``
    and ``packed_attention_smem_bytes`` return."""
    return 1024 + 64 * nwg * 128 + stages * 2 * bn * 128 + 16 * stages + 16


def _check_shape(b: int, sq: int, sk: int, h: int) -> None:
    if min(b, sq, sk, h) < 1:
        raise ValueError(f"empty attention: B={b}, Sq={sq}, Sk={sk}, heads={h}")


@functools.lru_cache(maxsize=None)
def plan(b: int, sq: int, sk: int, h: int, sms: int = SMS) -> Plan:
    """Consumer warpgroups, key tile and ring depth for a (B, Sq, Sk, heads)
    call, by the rules ``python -m genima_torch.tune_kernels attn`` chose:

    * key tile: 64 keys when Sk <= 64, 80 when Sk <= 80 (the 77 prompt
      tokens in one tile: TMA zero-fills keys 77-79 and the mask drops
      them), else 128;
    * warpgroups: two or three (``long_loop_warpgroups``: 128 or 192 query
      rows a block, sharing each K/V stage) once the key loop is
      ``LONG_KEY_LOOP`` tiles or more, even below a wave (1024 tokens x 10
      heads: 80 blocks of two beat 160 of one); one when it is shorter,
      where a block's fixed cost dominates and more, smaller blocks finish
      first;
    * ring: as deep as the K/V tiles need, at most four stages.
    """
    _check_shape(b, sq, sk, h)
    bn = 64 if sk <= 64 else 80 if sk <= 80 else 128
    nwg = long_loop_warpgroups(b, sq, h, sms) if -(-sk // bn) >= LONG_KEY_LOOP else 1
    return make_plan(b, sq, sk, h, nwg, bn, sms=sms)


def long_loop_warpgroups(b: int, sq: int, h: int, sms: int = SMS) -> int:
    """Two or three consumer warpgroups for a long key loop: the grid that
    holds the card for less time, counted as rounds of one block an SM x
    64-row slices a block, a three-warpgroup slice at ``THREE_WG_ROW_COST``;
    a tie goes to three. At the SD levels: three at 1x4096 x 5 heads (110
    blocks, one round, against 160) and at 4x1024 x 10 heads (240 blocks in
    two rounds against 320 in three), two at 4x4096 x 5 heads (640 blocks
    in five rounds against 440 in four of 1.5x the rows) and at 1x1024."""
    def cost(nwg: int) -> float:
        rounds = -(-(-(-sq // (64 * nwg)) * h * b) // sms)
        return rounds * nwg * (THREE_WG_ROW_COST if nwg == 3 else 1.0)

    return 3 if cost(3) <= cost(2) else 2


def make_plan(b: int, sq: int, sk: int, h: int, nwg: int, bn: int, stages: int | None = None,
              sms: int = SMS, tiles=TILES) -> Plan:
    """The launch for a chosen tile of ``tiles`` (the instantiations of the
    kernel's source); the ring depth as ``plan`` derives it unless given."""
    _check_shape(b, sq, sk, h)
    if (nwg, bn) not in tiles:
        raise ValueError(f"no kernel for {nwg} warpgroups x {bn}-key tiles")
    kv_tiles = -(-sk // bn)
    if stages is None:
        stages = min(kv_tiles, MAX_STAGES)
    # a stage goes back to the producer only once the next tile has arrived
    if not (2 if kv_tiles > 1 else 1) <= stages <= MAX_STAGES:
        raise ValueError(f"{stages} stages for {kv_tiles} K/V tiles")
    grid = (-(-sq // (64 * nwg)), h, b)
    blocks = grid[0] * grid[1] * grid[2]
    why = ""
    if blocks < sms:
        why = f"{grid[0]} tiles of {64 * nwg} query rows x {h} heads x batch {b}"
        if nwg > 1:
            why += f", {nwg} warpgroups sharing each of {kv_tiles} K/V tiles"
    return Plan(nwg=nwg, bn=bn, stages=stages, kv_tiles=kv_tiles, grid=grid,
                smem_bytes=smem_bytes(nwg, bn, stages), why_short=why)


def _plan_for(b: int, sq: int, sk: int, h: int) -> Plan:
    """The plan a call launches (``tune_kernels`` and the card tests swap in
    others)."""
    return plan(b, sq, sk, h)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
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
    p = _plan_for(b, sq, k.shape[1], h)
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     b, sq, k.shape[1], h, p.nwg, p.bn, p.stages, stream)
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
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
