"""Weight-only int8 matmul: int8 weights widened to bf16 inside the kernel.

Replaces the TPU kernel of ``genima_tpu/kernels/w8_matmul.py``
(``_w8_matmul_2d`` -> ``_kernel``, and ``w8_matmul_interpret``, the same
kernel body). Per-output-column symmetric quantization,
``w ~= w_q * scale``, so ``x @ w ~= (x @ w_q) * scale``: the scale factors
out of the contraction and is applied once to the f32 accumulator.

Layout: ``w_q`` is ``(N, K)`` int8, one row per output column, as
``nn.Linear.weight`` stores a weight (the JAX kernel takes ``(K, N)``;
``weights.from_jax`` transposes ``kernel_q`` on load). Each output
column's K values are then contiguous, the K-major layout in which TMA
brings weight rows in as the kernel's wgmma A operand.

* CUDA: ``csrc/w8_matmul.cu``, a swap-AB wgmma GEMM (the weight tile is
  the A operand, widened from int8 in registers once; the token tile is B)
  fed by a TMA + mbarrier ring of 128-wide K tiles, with a split-K whose
  partials are summed in a fixed order by the last block of each tile, so
  results are bit-identical from call to call. ``plan`` picks the token
  tile, the split and the ring depth per shape. Takes bf16 x, K % 16 == 0
  and N % 8 == 0; anything else raises. Bound: weight bytes at M <= 256,
  tensor cores at M = 4096.
* CPU: ``w8_matmul_reference``, the JAX fallback's arithmetic (x rounded to
  bf16, exact int8 values, f32 accumulate, ``* scale``, cast to x's dtype).
  The wrapper takes it only for tensors that lie on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
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


SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_BLOCK = 232448  # dynamic shared memory one block may use (227 KB)
SMEM_TWO_BLOCKS = 115712  # each of two blocks that share an SM (1 KB reserved each)
BK = 128  # K per ring stage
BN = 64  # weight rows per block (one consumer warpgroup)
TOKEN_TILES = (64, 80, 128)  # the wgmma N of the token tile
MAX_SPLIT = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: tile (``bt`` tokens x 64 weight rows), K split,
    ring depth, and what they imply."""

    bt: int
    split: int
    stages: int
    k_tiles: int
    grid: tuple[int, int, int]  # (N tiles, token tiles, split)
    smem_bytes: int
    workspace_floats: int  # f32 partials, 0 without a split
    tickets: int  # per-tile counters, 0 without a split
    why_short: str  # why the grid is under one wave ("" if it is not)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def tiles(self) -> int:
        return self.grid[0] * self.grid[1]

    def k_ranges(self) -> list[tuple[int, int]]:
        """The K tiles of each split, as the kernel computes them."""
        kt, s = self.k_tiles, self.split
        return [(z * kt // s, (z + 1) * kt // s) for z in range(s)]


def smem_bytes(bt: int, stages: int) -> int:
    """Dynamic shared memory of one block: 1 KB of alignment slack, the
    ring (int8 W box + two bf16 x boxes per stage) and its barriers.
    Mirrors ``w8_matmul_smem_bytes`` in the source."""
    return 1024 + stages * (BN * BK + 2 * bt * 128) + 16 * stages + 16


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int = SMS) -> Plan:
    """Tile, split-K and ring depth for an (M, K) x (K, N) call.

    * token tile: the smallest of 64, 80, 128 that holds M, else 128;
    * split: none once the tiles make half a wave; below that, the fewest
      splits of the K tiles (at most 4) that reach half a wave. Measured
      on the H100 (``python -m genima_torch.tune_kernels w8``): past that a
      split's f32 partials cost more than the extra blocks gain, and a
      deep ring per block does better;
    * ring: as deep as a split's K tiles need, within one block's shared
      memory when the grid fits the SMs, else within half an SM's, so that
      two blocks share an SM.
    """
    if m < 1 or k < 16 or n < 8:
        raise ValueError(f"M={m}, K={k}, N={n}: every dimension must be positive (K >= 16, N >= 8)")
    if k % 16 or n % 8:
        raise ValueError(f"K={k} must be a multiple of 16 and N={n} of 8")
    bt = next((t for t in TOKEN_TILES if m <= t), TOKEN_TILES[-1])
    tiles = -(-n // BN) * -(-m // bt)
    half_wave = -(-sms // 2)
    split = 1 if tiles >= half_wave else min(-(-k // BK), MAX_SPLIT, -(-half_wave // tiles))
    return make_plan(m, k, n, bt, split, sms=sms)


def make_plan(m: int, k: int, n: int, bt: int, split: int = 1, stages: int | None = None,
              sms: int = SMS) -> Plan:
    """The launch for a chosen token tile and split; the ring depth as
    ``plan`` derives it unless given."""
    k_tiles = -(-k // BK)
    m_tiles, n_tiles = -(-m // bt), -(-n // BN)
    tiles = n_tiles * m_tiles
    if not 1 <= split <= k_tiles or bt not in TOKEN_TILES:
        raise ValueError(f"no such launch: bt={bt}, split={split} of {k_tiles}")
    blocks = tiles * split
    per_split = -(-k_tiles // split)
    budget = SMEM_BLOCK if blocks <= sms else SMEM_TWO_BLOCKS
    stage = BN * BK + 2 * bt * 128
    # a stage is handed back only once the next one's first group is issued,
    # so a split of two or more K tiles needs two stages
    least = 1 if per_split == 1 else 2
    stages = stages or max(least, min(per_split, (budget - 1040) // (stage + 16)))
    if stages < least:
        raise ValueError(f"{per_split} K tiles a split need at least two stages")
    why = ""
    if blocks < sms:
        why = (f"{tiles} tiles of {bt} tokens x {BN} weight rows, split {split} of "
               f"{k_tiles} K tiles: more splits measured slower (partials)")
    return Plan(bt=bt, split=split, stages=stages, k_tiles=k_tiles,
                grid=(n_tiles, m_tiles, split), smem_bytes=smem_bytes(bt, stages),
                workspace_floats=split * tiles * BN * bt if split > 1 else 0,
                tickets=tiles if split > 1 else 0, why_short=why)


# split-K workspace and tile counters per (device, stream), grown on demand
# and reused by every call on that stream: calls on one stream are ordered,
# and two streams running split calls at once never share counters. Growing
# zeroes the new counters: the one launch besides the kernel's, once per
# larger plan, never per call.
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, p: Plan, stream: torch.cuda.Stream) -> tuple[int, int]:
    if p.split == 1:
        return 0, 0
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, stream.cuda_stream)
    ws, tickets = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < p.workspace_floats or tickets.numel() < p.tickets:
        need_ws = max(p.workspace_floats, 0 if ws is None else ws.numel())
        need_t = max(p.tickets, 0 if tickets is None else tickets.numel())
        ws = torch.empty(need_ws, device=device, dtype=torch.float32)
        tickets = torch.zeros(need_t, device=device, dtype=torch.int32)
        _scratch[key] = (ws, tickets)
    return ws.data_ptr(), tickets.data_ptr()


def _plan_for(m: int, k: int, n: int) -> Plan:
    """The plan a call launches (``tune_kernels`` and the card tests swap
    in others)."""
    return plan(m, k, n)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("w8_matmul")
    lib.w8_matmul.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.w8_matmul.restype = ctypes.c_int
    lib.w8_matmul_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.w8_matmul_smem_bytes.restype = ctypes.c_int
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
    if m == 0:
        raise ValueError("x has no rows")


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
    p = _plan_for(m, k, n)
    out = torch.empty(m, n, device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        ws, tickets = _workspace(x.device, p, stream)
        rc = lib.w8_matmul(x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           m, n, k, p.bt, p.split, p.stages, ws, tickets, stream.cuda_stream)
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
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
