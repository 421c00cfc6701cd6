"""Fused GroupNorm-SiLU-conv3x3 for the VAE decoder under ``conv_backend="fused"``.

Replaces the TPU kernel of ``genima_tpu/kernels/fused_conv.py``
(``fused_conv3x3`` -> ``_forward`` -> ``_band_kernel``) and its custom VJP
(``_fwd`` / ``_bwd``) as ``FusedConv3x3``, a ``torch.autograd.Function``
whose backward recomputes through the plain version's autograd (the VAE is
frozen in training; this kernel serves inference).

    y = conv3x3(silu(x * scale + shift)) + b [+ x @ wskip] [+ residual]

Layouts are the JAX package's: x and y NHWC ``(B, H, W, C)``, w HWIO
``(3, 3, C, O)``, scale/shift ``(B, C)`` (the folded GroupNorm of
``fold_group_norm``), wskip ``(C, O)``, residual ``(B, H, W, O)``.

* CUDA: ``csrc/fused_conv.cu``, a persistent, warp-specialised
  implicit-GEMM conv: a producer warp streams each 64-channel halo band and
  its per-tap weight tiles through TMA + mbarrier rings; the consumer
  warpgroups (one per image row of the tile) apply the GroupNorm affine
  and SiLU to the band in shared memory once, so the normalised activation
  never reaches device memory, then run the nine taps as wgmma with the
  shifted band in registers (ldmatrix). wskip is one more K-slice on the
  raw band, the residual is added in the epilogue. ``plan`` picks the
  tile. Takes bf16 x, C % 8 == 0, and every O (conv_out's 3 included: w is
  padded to a multiple of 8 output channels here). The TPU wrapper's routing to XLA (C % 128, O < 128) and
  its VMEM channel split are lane and VMEM rules of that chip and are not
  ported. Bound: tensor-core operations at the decoder's widths, input
  bytes for conv_out.
  On f32 x it launches the same source's f32 kernel instead, as the TPU
  kernel keeps x's dtype: the same persistent implicit GEMM on the TF32
  tensor cores with every product split in three (3xTF32: big x big, big
  x small, small x big, with big = tf32(a) and small = tf32(a - big)), so
  it keeps f32's accuracy where one TF32 pass would not; the activation,
  sums and output in f32, 32-channel bands, the weights handed over
  K-major as (9, O, C) (``plan(..., f32=True)``), any O.
* CPU: ``fused_conv3x3_reference``, the kernel's arithmetic in plain
  PyTorch. The wrapper takes it only for tensors that lie on the CPU.

``fold_group_norm`` and ``gn_silu_conv3x3`` are plain PyTorch, as they are
plain XLA in JAX.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from genima_torch.kernels import _build


def fused_conv3x3_reference(x, w, b, scale=None, shift=None, wskip=None, residual=None):
    """Plain version: silu(x * scale + shift) in f32 rounded to x's dtype,
    the conv accumulated in f32, bias, skip and residual added in f32, one
    final rounding to x's dtype."""
    h = x
    if scale is not None:
        h = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
        h = (h * torch.sigmoid(h)).to(x.dtype)
    y = F.conv2d(h.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    if wskip is not None:
        y = y + torch.matmul(x.float(), wskip.float())
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


SMS = 132  # streaming multiprocessors of an H100 SXM
TILE_W, CHUNK = 64, 64  # output columns per tile, input channels per band
F32_CHUNK = 32  # input channels per band of the f32 kernel (128 bytes a pixel)
BAND_STAGES, W_STAGES = 2, 4
# (output channels, image rows) per tile that the source instantiates: one
# consumer warpgroup per row, wgmma N = output channels. Measured on the
# H100 (``python -m genima_torch.tune_kernels conv``): 128 x 2 beats 256 x 2
# and 128 x 4 at every decoder shape (both spill: ptxas gives a 288-thread
# block at most 168 registers, a 544-thread one 96); 16 x 4 beats 16 x 2 at
# conv_out, where the per-tap latency is worth four warpgroups. The f32
# kernel instantiates the same two.
TILES = ((128, 2), (16, 4))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: ``bn`` output channels per tile, the tiles, and
    the persistent blocks that walk them (block b takes tiles b, b +
    blocks, ...)."""

    bn: int
    rows: int  # image rows per tile, one consumer warpgroup each
    tiles: tuple[int, int, int]  # (pixel tiles, output-channel blocks, batch)
    blocks: int  # persistent blocks, one an SM at most
    chunks: int  # bands per tile (64 channels, or 32 for f32)
    smem_bytes: int
    why_short: str  # why the grid is under one wave ("" if it is not)
    f32: bool = False  # the 3xTF32 kernel

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1] * self.tiles[2]


def smem_bytes(bn: int, rows: int, f32: bool = False) -> int:
    """Dynamic shared memory of one block: 1 KB of alignment slack, the
    band ring ((rows + 2) x 66 pixels x 128 bytes a stage, in whole KB: 64
    bf16 or 32 f32 channels), the weight ring (a tap's weights a stage: 64
    x bn bf16, or 32 x bn f32 and their remainders') and the barriers.
    Mirrors ``fused_conv3x3_smem_bytes`` and ``fused_conv3x3_f32_smem_bytes``
    in the source."""
    band = -(-(rows + 2) * (TILE_W + 2) * 128 // 1024) * 1024
    w_stage = 2 * F32_CHUNK * bn * 4 if f32 else CHUNK * bn * 2
    # full and empty barriers a stage, and a "ready" one a weight stage in f32
    barriers = 16 * (BAND_STAGES + W_STAGES) + (8 * W_STAGES if f32 else 0)
    return 1024 + BAND_STAGES * band + W_STAGES * w_stage + barriers


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, o: int, sms: int = SMS, f32: bool = False) -> Plan:
    """Tile for a (B, H, W, C) -> O call (``f32``: of the 3xTF32 kernel):
    16 output channels over four image rows for conv_out's few channels,
    else 128 over two. One persistent block per SM (the rings take most of
    its shared memory), or one per tile when there are fewer tiles."""
    if min(b, h, w, c, o) < 1:
        raise ValueError(f"empty conv: B={b}, H={h}, W={w}, C={c}, O={o}")
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    bn, rows = TILES[1] if o <= 16 else TILES[0]
    return make_plan(b, h, w, c, o, bn, rows, sms, f32=f32)


def make_plan(b: int, h: int, w: int, c: int, o: int, bn: int, rows: int,
              sms: int = SMS, f32: bool = False) -> Plan:
    """The launch for a chosen tile."""
    if (bn, rows) not in TILES:
        raise ValueError(f"no kernel for {bn} output channels x {rows} rows")
    opad = -(-o // 8) * 8
    grid = (-(-h // rows) * -(-w // TILE_W), -(-opad // bn), b)
    n_tiles = grid[0] * grid[1] * grid[2]
    why = (f"{grid[0] * b} tiles of {rows}x{TILE_W} pixels x {grid[1]} blocks of {bn} "
           f"output channels" if n_tiles < sms else "")
    return Plan(bn=bn, rows=rows, tiles=grid, blocks=min(n_tiles, sms),
                chunks=-(-c // (F32_CHUNK if f32 else CHUNK)),
                smem_bytes=smem_bytes(bn, rows, f32), why_short=why, f32=f32)


def _plan_for(b: int, h: int, w: int, c: int, o: int, *, dtype=torch.bfloat16) -> Plan:
    """The plan a call launches: ``plan``'s for x's dtype (``tune_kernels``
    and the card tests swap in others)."""
    return plan(b, h, w, c, o, f32=dtype == torch.float32)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_conv")
    lib.fused_conv3x3.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.fused_conv3x3.restype = ctypes.c_int
    lib.fused_conv3x3_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fused_conv3x3_smem_bytes.restype = ctypes.c_int
    lib.fused_conv3x3_error_string.argtypes = [ctypes.c_int]
    lib.fused_conv3x3_error_string.restype = ctypes.c_char_p
    # f32: eight pointers, (B, H, W, C, O, bn, rows, blocks), the stream
    lib.fused_conv3x3_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.fused_conv3x3_f32.restype = ctypes.c_int
    lib.fused_conv3x3_f32_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.fused_conv3x3_f32_smem_bytes.restype = ctypes.c_int
    return lib


def _pad_out(t: torch.Tensor, opad: int) -> torch.Tensor:
    """(..., O) -> (..., opad) with zero columns: the kernel loads weight
    rows in 16-byte pieces."""
    return t if t.shape[-1] == opad else F.pad(t, (0, opad - t.shape[-1]))


def _check_cuda_inputs(x, w, b, scale, shift, wskip, residual) -> None:
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32 on CUDA, got {x.dtype}")
    if w.shape != (3, 3, c, o) or b.shape != (o,):
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not fit C={c}")
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together")
    for name, t, shape in (("scale", scale, (bsz, c)), ("shift", shift, (bsz, c)),
                           ("wskip", wskip, (c, o)), ("residual", residual, (bsz, h, wd, o))):
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")


def _count(x, o: int) -> None:
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
        fused_conv3x3.launches += 1
        fused_conv3x3.launches_by_shape[(*x.shape, o)] += 1


def _launch_f32(x, w, b, scale, shift, wskip, residual) -> torch.Tensor:
    """The 3xTF32 kernel: every operand in f32, the weights K-major (one
    transposing copy a call, as the bf16 path casts its weights), f32 out."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    p = _plan_for(bsz, h, wd, c, o, dtype=x.dtype)
    operands = [
        x.contiguous(),
        w.float().reshape(9, c, o).transpose(1, 2).contiguous(),
        b.float().contiguous(),
        None if scale is None else scale.float().contiguous(),
        None if shift is None else shift.float().contiguous(),
        None if wskip is None else wskip.float().t().contiguous(),
        None if residual is None else residual.float().contiguous(),
    ]
    for t in operands:
        if t is not None and (t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"every operand must be 16-byte aligned on {x.device}")
    out = torch.empty(bsz, h, wd, o, device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_conv3x3_f32(*[None if t is None else t.data_ptr() for t in operands],
                                   out.data_ptr(), bsz, h, wd, c, o, p.bn, p.rows, p.blocks,
                                   stream)
    _count(x, o)
    if rc != 0:
        raise RuntimeError(
            f"fused_conv3x3_f32 launch failed: {lib.fused_conv3x3_error_string(rc).decode()} "
            f"({rc})")
    return out


def _launch(x, w, b, scale, shift, wskip, residual) -> torch.Tensor:
    _check_cuda_inputs(x, w, b, scale, shift, wskip, residual)
    if x.dtype == torch.float32:
        return _launch_f32(x, w, b, scale, shift, wskip, residual)
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    p = _plan_for(bsz, h, wd, c, o)
    opad = -(-o // 8) * 8
    operands = dict(
        x=x.contiguous(),
        w=_pad_out(w.to(torch.bfloat16).reshape(9, c, o), opad).contiguous(),
        b=b.float().contiguous(),
        scale=None if scale is None else scale.float().contiguous(),
        shift=None if shift is None else shift.float().contiguous(),
        wskip=None if wskip is None else _pad_out(wskip.to(torch.bfloat16), opad).contiguous(),
        residual=None if residual is None else residual.to(torch.bfloat16).contiguous(),
    )
    for name, t in operands.items():
        if t is not None and (t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"{name} must be 16-byte aligned on {x.device}")
    out = torch.empty(bsz, h, wd, o, device=x.device, dtype=torch.bfloat16)
    ptrs = [0 if t is None else t.data_ptr() for t in operands.values()]
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_conv3x3(*ptrs, out.data_ptr(), bsz, h, wd, c, o, opad, p.bn, p.rows,
                               p.blocks, stream)
    _count(x, o)
    if rc != 0:
        raise RuntimeError(
            f"fused_conv3x3 launch failed: {lib.fused_conv3x3_error_string(rc).decode()} ({rc})")
    return out


def _forward(x, w, b, scale, shift, wskip, residual) -> torch.Tensor:
    """The kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return fused_conv3x3_reference(x, w, b, scale, shift, wskip, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w, b, scale, shift, wskip, residual)


class FusedConv3x3(torch.autograd.Function):
    """The TPU package's ``custom_vjp``: the kernel forward; the backward
    recomputes through the plain version's autograd."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, wskip, residual):
        ctx.save_for_backward(x, w, b, scale, shift, wskip, residual)
        return _forward(x, w, b, scale, shift, wskip, residual)

    @staticmethod
    def backward(ctx, dy):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_() for t in inputs]
            out = fused_conv3x3_reference(*leaves)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, dy))
        return tuple(None if t is None else next(grads) for t in leaves)


def fused_conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    wskip: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = conv3x3(silu(x*scale + shift)) + b [+ x@wskip] [+ residual],
    NHWC in and out; ``scale=None`` is a plain conv with no activation."""
    args = (x, w, b, scale, shift, wskip, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return FusedConv3x3.apply(*args)
    return _forward(*args)


def fold_group_norm(x, gamma, beta, groups: int, eps: float):
    """Per-batch folded GroupNorm affine of NHWC x: (scale, shift), each
    (B, C) f32, with gn(x) == x * scale[:, None, None] + shift[:, None, None].

    Single pass, E[x^2] - E[x]^2 with f32 accumulation over x's own dtype,
    as the JAX package computes it: neither sum materialises an f32 copy of
    x (the sum of squares is a 2-norm accumulated in f32)."""
    bsz, h, w, c = x.shape
    xg = x.reshape(bsz, h * w, groups, c // groups)
    n = h * w * (c // groups)
    mean = xg.mean(dim=(1, 3), dtype=torch.float32)
    mean2 = torch.linalg.vector_norm(xg, dim=(1, 3), dtype=torch.float32).square() / n
    # f32 cancellation can leave E[x^2] - E[x]^2 slightly negative when the
    # mean dominates the std; rsqrt(negative + eps) would give NaN
    var = (mean2 - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)  # (B, G)
    inv_c = inv.repeat_interleave(c // groups, dim=1)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    scale = gamma.float()[None, :] * inv_c
    shift = beta.float()[None, :] - mean_c * scale
    return scale, shift


def gn_silu_conv3x3(x, w, b, gamma, beta, groups: int = 32, eps: float = 1e-6,
                    wskip=None, skip_bias=None, residual=None):
    """GroupNorm(groups) -> SiLU -> conv3x3 (+ bias), with an optional
    un-normalised 1x1 shortcut and residual add, through one kernel call."""
    scale, shift = fold_group_norm(x, gamma, beta, groups, eps)
    bb = b if skip_bias is None else b + skip_bias
    return fused_conv3x3(x, w, bb, scale, shift, wskip, residual)


# kernel launches since the last reset, in all and by (B, H, W, C, O)
fused_conv3x3.launches = 0
fused_conv3x3.launches_by_shape = collections.Counter()
