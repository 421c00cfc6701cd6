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
  column offset ``h * d``; one to three consumer warpgroups of 64 query
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
  Takes bf16 and every head dim d >= 1 (the tiny configs' 16/32, SD's 64,
  SD-1.5's 40/80/160, the wide-head SD's 320/640; read as ceil(d / 64)
  atoms of 64 columns, the columns past d zeroed where a product sums over
  them and never stored; a d that is not a multiple of 8 zero-padded to
  the next one in scratch copies first, as TMA needs 16-byte row strides,
  with the kernels scaled by the real d and only its d columns kept). Up
  to four atoms a block holds O (dQ, dK, dV) whole; above (d > 256: five
  atoms of f32 accumulator would pass a thread's registers) B1/B2a's paired
  kernel holds five or six atoms in two warpgroups of one block, the
  streaming forwards keep one chunk of three or four atoms a block and
  stream every atom of the head through a ring (``fa.wide_chunking``,
  ``fa.wide_plan``), and B2b launches a dq, a dV and a dK kernel whose
  blocks hold the whole head up to ten atoms in two warpgroups that split
  S and dP between them (``wide_backward_plan``). B1 and B2a take
  any ``Sq``, ``Sk`` >= 1, every length the TPU forward takes (``_forward``:
  Sq <= 128 with K/V resident, ``_forward_streaming``: multiples of 128)
  and more (keys past Sk masked, query rows past Sq never stored); B2b takes
  multiples of 64 (``kernel_tiles``; 9216 at 768x768, 16384 at
  1024x1024), and autograd recomputes the gradient of any other shape
  through the plain version, as JAX's ``_fwd`` does.
  On f32 q, k and v (``--mixed_precision no``, f32 serving) B1, B2a and B2b
  launch the 3xTF32 kernels instead (``csrc/attention_f32_hopper.cuh``'s
  forward, ``csrc/packed_attention_bwd.cu``'s f32 dq and dk/dv kernels):
  every f32 product split into three TF32 ones on the tensor cores (wgmma
  for S, dP and their transposes, mma.sync for the products over a tile's
  rows), P and dS kept in f32, o, L, dq, dk and dv in f32, as the TPU
  kernels write q's dtype; any head dim (one off a multiple of 4
  zero-padded; above four atoms the wide f32 kernels), the same Sq and Sk.
  No bf16 round trip.
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

HEAD_DIM = fa.HEAD_DIM
BLOCK = 64  # B2b's Sq and Sk are multiples of this: its 64-row tiles
# B1/B2a: (consumer warpgroups of 64 query rows, keys a K/V tile), the
# instantiations of packed_attention.cu at head dims up to 64: those
# ``forward_plan`` picks at some shape (B3's 80-key tile for the 77 prompt
# tokens is not built: no path sends B1 the prompt, and the autograd
# fallback's kv = 77 takes one 128-key tile; 64-key tiles with two or three
# warpgroups never beat 128-key ones, tune_kernels packed)
FORWARD_TILES = ((1, 64), (1, 128), (2, 128), (3, 128))
# and at 72..192 (two or three 64-column atoms): one block an SM
WIDE_FORWARD_TILES = ((1, 64), (2, 64))
# and at 200..256 (four atoms): one consumer warpgroup, 160 threads; above,
# the wide kernel's (fa.WIDE_HEAD_TILES), also one warpgroup on 64-key tiles
WIDEST_FORWARD_TILES = ((1, 64),)
# B2b: query rows (dq kernel) or keys (dk/dv kernel) a block, two consumer
# warpgroups of 64, and the depth of each kernel's TMA ring (at one or two
# atoms; three and four atoms ring two stages, and four take one consumer
# warpgroup of 64 rows beside a one-warp producer)
BWD_BLOCK_ROWS = 128
BWD_STAGES = 4
BWD_THREADS = 384  # two consumer warpgroups and the producer warpgroup
SMS = 132  # streaming multiprocessors of an H100 SXM
REGISTERS_SM = 65536


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """B2b's two launches for a (B, Sq, Sk, heads) call at head dim d: the
    dq kernel's grid walks query blocks, the dk/dv kernel's key blocks, each
    over (blocks, heads, batch); shared memory mirrors
    ``packed_attention_bwd_smem_bytes`` in the source. Heads of two or three
    atoms keep the block's resident tensors in shared memory and make two
    passes over the queries in the dk/dv kernel (``passes``)."""

    dq_grid: tuple[int, int, int]
    dkdv_grid: tuple[int, int, int]
    dq_smem_bytes: int
    dkdv_smem_bytes: int
    why_short: str  # why a grid is under one wave ("" if neither is)
    atoms: int = 1
    stages: int = BWD_STAGES
    passes: int = 1
    rows: int = BWD_BLOCK_ROWS  # query rows or keys a block
    threads: int = BWD_THREADS
    tile: int = BLOCK  # rows a streamed tile (of the dq kernel, where they differ)
    dkdv_tile: int = BLOCK
    dkdv_stages: int = BWD_STAGES
    chunks: int = 1  # column chunks of dQ, dK, dV, one a block (the wide kernels)
    dv_smem_bytes: int = 0  # the wide kernels' dV launch (below: dV is the dk/dv kernel's)
    out_atoms: int = 0  # the wide kernels: atoms of the output a consumer warpgroup holds
    resident: bool = False  # the wide bf16 kernels: the block's rows resident
    splits: int = 1  # the wide kernels: ranges of the dq kernel's key tiles (a cluster)
    dkdv_splits: int = 1  # and of the dV and dK kernels' query tiles

    @property
    def max_registers(self) -> int:
        """ptxas's cap from the launch bounds (one block an SM): 168 at 384
        threads, from which setmaxnreg moves the producer to 24 and the
        consumers to 240; 255 at four atoms' 160."""
        return min(255, REGISTERS_SM // self.threads // 8 * 8)


def f32_backward_nwg(atoms: int) -> int:
    """Consumer warpgroups of 64 rows a block of the f32 backward's two
    kernels: two at one atom, one at two to four (shared memory). Mirrors
    ``bwd_nwg`` in ``csrc/packed_attention_bwd.cu``."""
    return 2 if atoms == 1 else 1


def f32_backward_tile(atoms: int, dkdv: bool = False) -> int:
    """Rows a streamed tile of the f32 backward (``bwd_tile``): 64, 32, 16
    and 8 at one to four atoms, but 16 in the dk/dv kernel at two (its dK
    and dV, live beside S^T and dP^T, spilled at 32)."""
    return 16 if dkdv and atoms == 2 else 128 >> atoms


def f32_backward_stages(atoms: int, dkdv: bool = False) -> int:
    """Depth of the f32 backward's ring (``bwd_stages``)."""
    return 4 if dkdv and atoms == 2 else 3 if atoms == 4 else 2


def f32_backward_smem_bytes(atoms: int, dkdv: bool) -> int:
    """Shared memory of an f32 backward block: alignment slack, two resident
    tensors, a ring of four tiles (two tensors and their 3xTF32 remainders),
    in the dk/dv kernel a stage's L * log2(e) and Drow, and the barriers.
    Mirrors ``bwd_smem_bytes`` in ``csrc/packed_attention_bwd.cu``."""
    slabs = 2 * atoms
    tile, stages = f32_backward_tile(atoms, dkdv), f32_backward_stages(atoms, dkdv)
    return (1024 + 2 * 64 * f32_backward_nwg(atoms) * slabs * fa.F32_SLAB_BYTES
            + stages * (4 * tile * slabs * fa.F32_SLAB_BYTES + (8 * tile if dkdv else 0))
            + 8 * (3 * stages + 1))


# B2b past four atoms (csrc/packed_attention_bwd.cu, the wide section):
# three launches (dq, dV, dK) of 384 threads, two consumer warpgroups each
# holding ``wide_backward_out_atoms`` atoms of the output
WIDE_BWD_THREADS = 384
WIDE_BWD_ATOM_TILE = 64 * fa.ATOM * 2  # 64 rows x one 64-column bf16 atom
WIDE_BWD_XBUF = 128 * 32 * 4  # the warpgroups' hand-over buffer (bf16 kernels)
WIDE_BWD_MAX_O_STAGES = 20
WIDE_BWD_E_MAX = 16  # barriers an early ring
WIDE_BWD_F32_ITEMS = 6  # the f32 kernels' ring of 32 KB slots
WIDE_BWD_MODES = ("dq", "dk", "dv")  # kWideDq, kWideDk, kWideDv


def wide_backward_chunks(atoms: int, f32: bool = False) -> int:
    """Chunks of the head's output columns, one a block: one up to ten atoms
    (f32: eight), then chunks of eight. Mirrors ``wide_bwd_chunks`` /
    ``wide_bwd_chunks_f32``."""
    return -(-atoms // 8) if f32 or atoms > 10 else 1


def wide_backward_out_atoms(atoms: int, f32: bool = False) -> int:
    """Atoms of output a consumer warpgroup holds (``wide_bwd_oa`` /
    ``wide_bwd_oa_f32``): bf16 3 at five or six atoms, 4 at seven or eight,
    5 at nine or ten, 4 past; f32 the fewest (3 at least) that cover a
    chunk in two warpgroups."""
    if f32:
        return max(3, -(-atoms // (2 * wide_backward_chunks(atoms, True))))
    if atoms <= 6:
        return 3
    return 5 if 8 < atoms <= 10 else 4


def wide_backward_resident(atoms: int) -> bool:
    """Whether the bf16 kernels keep the block's rows resident (six atoms at
    most); past six they stream a tile at a time."""
    return atoms <= 6


def wide_backward_rings(mode: str, atoms: int) -> tuple[int, int, int]:
    """(shared memory, O ring depth, early ring depth) of a bf16 wide
    backward kernel; mirrors ``wide_bwd_fixed_bytes`` / ``wide_bwd_rings``:
    alignment slack, the resident rows, the hand-over buffer, a zero tile
    (output atoms past d), the barriers, then the rings. An early ring's
    slot is a tile atom with the rows resident, else a row atom and a tile
    atom; with the rows resident the O ring (8 KB atom tiles and two
    barriers each) takes two tiles where three early slots are left beside
    it and the early rings the rest; streaming, three early slots a
    warpgroup (dV's one ring six) and the O ring the rest, 20 at most."""
    res = wide_backward_resident(atoms)
    dv = mode == "dv"
    res_tensors = (1 if dv else 2) if res else 0
    e_bytes = ((1 if not res or dv else 0) + (0 if dv else 1)) * (1 if res else 2) * WIDE_BWD_ATOM_TILE
    fixed = (1024 + res_tensors * atoms * WIDE_BWD_ATOM_TILE + WIDE_BWD_XBUF + WIDE_BWD_ATOM_TILE
             + 8 * (4 * WIDE_BWD_E_MAX + 1))
    left, per_o = fa.SMEM_BLOCK - fixed, WIDE_BWD_ATOM_TILE + 16
    if res:
        o_atoms = min(atoms, 2 * wide_backward_out_atoms(atoms))
        o_stages = min(2 * o_atoms, (left - 3 * e_bytes) // per_o)
        e_stages = min(WIDE_BWD_E_MAX, (left - o_stages * per_o) // e_bytes)
    else:
        e_stages = 6 if dv else 3
        o_stages = min(WIDE_BWD_MAX_O_STAGES, (left - e_stages * e_bytes) // per_o)
    return fixed + o_stages * per_o + e_stages * e_bytes, o_stages, e_stages


def wide_backward_splits(blocks: int, tiles: int, sms: int = SMS) -> int:
    """Ranges of the wide backward's tile loop a block's rows take
    (``wide_bwd_splits``): 1 where the grid fills the card, else as many as
    keep it within one wave, two tiles each at least, ``fa.MAX_SPLITS`` at
    most; the splits of a block are the CTAs of a cluster, which sum their
    outputs in split order at the end."""
    if blocks >= sms:
        return 1
    return max(k for k in range(1, fa.MAX_SPLITS + 1)
               if k == 1 or (2 * k <= tiles and blocks * k <= sms))


def wide_backward_f32_smem() -> int:
    """Shared memory of an f32 wide backward kernel (``wide_bwd_smem_bytes_f32``):
    alignment slack, the ring, the hand-over buffer (16 values a consumer
    thread), three barriers a slot."""
    return 1024 + WIDE_BWD_F32_ITEMS * fa.WIDE_SLOT_BYTES + 128 * 16 * 4 + 24 * WIDE_BWD_F32_ITEMS


def wide_backward_plan(b: int, sq: int, sk: int, h: int, atoms: int, sms: int = SMS, *,
                       f32: bool = False) -> BackwardPlan:
    """B2b's wide kernels (more than four atoms): a dq launch over (64 query
    rows, chunk, head, batch), then a dV and a dK launch (``passes``) over
    (64 keys, chunk, head, batch), 384 threads each (two consumer
    warpgroups, ``out_atoms`` atoms of the output each, and a producer
    warpgroup). bf16: rows resident up to six atoms, an O ring of 8 KB atom
    tiles (``stages`` in dq, ``dkdv_stages`` in dK); f32: a ring of
    ``WIDE_BWD_F32_ITEMS`` 32 KB slots of 32-row tiles. Where a grid is
    short its tile loop is split (``splits``, ``dkdv_splits``: a cluster of
    CTAs a block's rows, each grid's x times that). Shared memory mirrors
    ``packed_attention_bwd_smem_bytes`` / ``_f32_smem_bytes`` (dq, dK,
    dV)."""
    chunks = wide_backward_chunks(atoms, f32)
    tile = 32 if f32 else BLOCK
    blocks = {name: -(-rows // BLOCK) * chunks for name, rows in (("dq", sq), ("dk/dv", sk))}
    splits = {name: wide_backward_splits(n * h * b, -(-other // tile), sms)
              for (name, n), other in zip(blocks.items(), (sk, sq))}
    dq, dkdv = ((blocks[name] * splits[name], h, b) for name in ("dq", "dk/dv"))
    short = [f"{name}: {n // chunks} blocks of 64 x {chunks} chunks x {h} heads x batch {b}"
             f" (the tiles split {splits[name]} ways)"
             for name, n in blocks.items() if n * h * b < sms]
    if f32:
        smem = (wide_backward_f32_smem(),) * 3
        stages = dk_stages = WIDE_BWD_F32_ITEMS
    else:
        (dq_smem, stages, _), (dk_smem, dk_stages, _), (dv_smem, _, _) = (
            wide_backward_rings(m, atoms) for m in WIDE_BWD_MODES)
        smem = (dq_smem, dk_smem, dv_smem)
    return BackwardPlan(
        dq_grid=dq, dkdv_grid=dkdv, dq_smem_bytes=smem[0], dkdv_smem_bytes=smem[1],
        dv_smem_bytes=smem[2], why_short="; ".join(short), atoms=atoms, stages=stages, passes=2,
        rows=BLOCK, threads=WIDE_BWD_THREADS, tile=tile, dkdv_tile=tile, dkdv_stages=dk_stages,
        chunks=chunks, out_atoms=wide_backward_out_atoms(atoms, f32),
        resident=not f32 and wide_backward_resident(atoms), splits=splits["dq"],
        dkdv_splits=splits["dk/dv"])


def backward_plan(b: int, sq: int, sk: int, h: int, d: int = HEAD_DIM,
                  sms: int = SMS, *, dtype=torch.bfloat16) -> BackwardPlan:
    """The fixed tiling of B2b (128-row blocks, a ring of 64-row tiles; on
    f32 the 3xTF32 kernels' blocks of 64 * ``f32_backward_nwg`` rows and
    tiles of ``f32_backward_tile``; above four atoms ``wide_backward_plan``)
    at one shape; raises for a shape the kernels do not take."""
    _check_shape(b, sq, sk, h)
    fa.check_head_dim(d)
    atoms = fa.head_atoms(fa.f32_padded_head_dim(d) if dtype == torch.float32 else d)
    if atoms > fa.NARROW_ATOMS:
        return wide_backward_plan(b, sq, sk, h, atoms, sms, f32=dtype == torch.float32)
    if dtype == torch.float32:
        rows = 64 * f32_backward_nwg(atoms)
        dq, dkdv = (-(-sq // rows), h, b), (-(-sk // rows), h, b)
        short = [f"{name}: {g[0]} blocks of {rows} x {h} heads x batch {b}"
                 for name, g in (("dq", dq), ("dk/dv", dkdv)) if g[0] * h * b < sms]
        return BackwardPlan(
            dq_grid=dq, dkdv_grid=dkdv, dq_smem_bytes=f32_backward_smem_bytes(atoms, False),
            dkdv_smem_bytes=f32_backward_smem_bytes(atoms, True), why_short="; ".join(short),
            atoms=atoms, stages=f32_backward_stages(atoms), passes=2 if atoms >= 3 else 1,
            rows=rows, threads=128 * f32_backward_nwg(atoms) + fa.F32_PRODUCER,
            tile=f32_backward_tile(atoms), dkdv_tile=f32_backward_tile(atoms, True),
            dkdv_stages=f32_backward_stages(atoms, True))
    stages = 2 if atoms >= 3 else BWD_STAGES
    rows, threads = (BLOCK, 160) if atoms == 4 else (BWD_BLOCK_ROWS, BWD_THREADS)
    tile = BLOCK * fa.ATOM * 2 * atoms  # 64 rows of every atom
    ring = stages * 2 * tile  # a Q/dO or K/V pair of tiles a stage
    # two resident tensors of a block's rows and their barrier (more than one atom)
    resident = 0 if atoms == 1 else 2 * rows // BLOCK * tile + 16
    dq = (-(-sq // rows), h, b)
    dkdv = (-(-sk // rows), h, b)
    short = [f"{name}: {g[0]} blocks of {rows} {what} x {h} heads x batch {b}"
             for name, g, what in (("dq", dq, "queries"), ("dk/dv", dkdv, "keys"))
             if g[0] * h * b < sms]
    dq_smem = 1024 + resident + ring + 16 * stages
    return BackwardPlan(
        dq_grid=dq, dkdv_grid=dkdv, dq_smem_bytes=dq_smem,
        # + each stage's 64 values of L * log2(e) and Drow
        dkdv_smem_bytes=dq_smem + stages * 2 * BLOCK * 4,
        why_short="; ".join(short), atoms=atoms, stages=stages, passes=1 if atoms == 1 else 2,
        rows=rows, threads=threads)


def _check_seq(sq: int, sk: int) -> None:
    for name, s in (("Sq", sq), ("Sk", sk)):
        if s % BLOCK or s <= 0:
            raise ValueError(f"{name}={s} must be a positive multiple of {BLOCK}")


def _check_shape(b: int, sq: int, sk: int, h: int) -> None:
    """Raises for a (B, Sq, Sk, heads) call the kernels do not take."""
    if min(b, h) < 1:
        raise ValueError(f"empty attention: B={b}, heads={h}")
    _check_seq(sq, sk)


def forward_tiles(d: int) -> tuple:
    """B1/B2a's instantiations at head dim ``d``."""
    atoms = fa.head_atoms(d)
    if atoms > fa.NARROW_ATOMS:
        return fa.WIDE_HEAD_TILES
    return {1: FORWARD_TILES, 4: WIDEST_FORWARD_TILES}.get(atoms, WIDE_FORWARD_TILES)


@functools.lru_cache(maxsize=None)
def forward_plan(b: int, sq: int, sk: int, h: int, d: int = HEAD_DIM,
                 sms: int = SMS) -> fa.Plan:
    """Consumer warpgroups, key tile and ring depth of B1 and B2a (one plan
    for both: the key tile sets the order of the online-softmax updates) for
    a (B, Sq, Sk, heads) call at head dim ``d``, by the rules ``python -m
    genima_torch.tune_kernels packed`` chose at d = 64:

    * a key loop of ``fa.LONG_KEY_LOOP`` 128-key tiles or more: two or
      three consumer warpgroups (128 or 192 query rows a block, sharing
      each K/V stage), as B3's ``fa.long_loop_warpgroups`` picks them;
    * a shorter one: one warpgroup, on 128-key tiles while the grid is at
      most one block an SM (1x256 x 20 heads: 80 blocks), else on 64-key
      tiles, whose block takes at most 136 registers so that three share
      an SM (4x256 x 20 heads: 320 blocks in one wave, 0.0094 ms against
      0.0111 on 128-key tiles); 64-key tiles also when Sk is 64;
    * ring: as deep as the K/V tiles need, at most four stages.

    Two- and three-atom heads (d = 72..192) take 64-key tiles, two
    warpgroups for a key loop of ``fa.LONG_KEY_LOOP`` tiles or more, and as
    deep a ring as shared memory leaves; four-atom heads (d = 200..256)
    64-key tiles, one warpgroup, three stages; wider heads the wide kernel
    (``fa.wide_plan``). Sq and Sk may be any length.

    Raises for a shape the kernel does not take.
    """
    fa.check_head_dim(d)
    atoms = fa.head_atoms(d)
    if atoms > fa.NARROW_ATOMS:
        nwg, bn = fa.wide_warpgroups(atoms, sk), 64
    elif atoms > 1:
        nwg, bn = (2 if atoms < 4 and -(-sk // 64) >= fa.LONG_KEY_LOOP else 1), 64
    elif -(-sk // 128) >= fa.LONG_KEY_LOOP:
        nwg, bn = fa.long_loop_warpgroups(b, sq, h, sms), 128
    else:
        nwg, bn = 1, 64 if sk <= 64 or -(-sq // 64) * h * b > sms else 128
    return make_forward_plan(b, sq, sk, h, nwg, bn, sms=sms, d=d)


def make_forward_plan(b: int, sq: int, sk: int, h: int, nwg: int, bn: int,
                      stages: int | None = None, sms: int = SMS, d: int = HEAD_DIM) -> fa.Plan:
    """B1/B2a's launch for a chosen tile; the ring depth as ``forward_plan``
    derives it unless given. The shared memory mirrors
    ``packed_attention_smem_bytes`` in the source."""
    return fa.make_plan(b, sq, sk, h, nwg, bn, stages, sms=sms, tiles=forward_tiles(d), d=d)


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


def packed_attention_split_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, splits: int,
    tile: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the clustered wide kernel's key split (B1 and B2a
    where ``forward_plan`` gives ``splits`` > 1): the keys cut into
    ``splits`` ranges of whole ``tile``-key tiles (range s from tile s * n /
    splits, ``split_begin`` in ``csrc/attention_hopper.cuh``), each range's
    row max m_s, sum l_s and unnormalised O_s (P rounded to v's dtype before
    P V) formed alone, then merged in range order: m the max, l and O the
    sums of l_s and O_s rescaled by exp(m_s - m). Returns o in q's dtype and
    L = m + log(l) as (B, Sq, heads) f32, as ``packed_attention_lse_reference``."""
    d = q.shape[-1] // num_heads
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    n = -(-k.shape[1] // tile)
    parts = []
    for i in range(splits):
        lo, hi = i * n // splits * tile, min((i + 1) * n // splits * tile, k.shape[1])
        s = torch.matmul(qh, kh[:, :, lo:hi].transpose(-1, -2)) * (1.0 / math.sqrt(d))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.matmul(p.to(v.dtype).float(), vh[:, :, lo:hi])))
    m = parts[0][0]
    for part in parts[1:]:
        m = torch.maximum(m, part[0])
    l = sum(ls * torch.exp(ms - m) for ms, ls, _ in parts)
    o = sum(os * torch.exp(ms - m) for ms, _, os in parts) / l
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


def packed_attention_backward_split_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, num_heads: int, splits: int, tile: int = BLOCK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the wide backward's split tile loop (``splits`` > 1
    in ``wide_backward_plan``): dq as the sum over ``splits`` ranges of whole
    ``tile``-key tiles, dk and dv over ranges of query tiles (range s from
    tile s * n / splits, ``split_begin``; at most one range a tile), each
    range's part formed alone with ``packed_attention_backward_reference``'s
    arithmetic and the parts summed in range order, as the cluster's merge
    sums them. Returns dq, dk, dv in q's dtype."""
    dtype = q.dtype
    d = q.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, oh = (_heads(x, num_heads) for x in (q, k, v, o))
    doh = _heads(do.to(dtype), num_heads)
    lh = lse.float().transpose(1, 2).unsqueeze(-1)
    drow = (doh * oh).sum(dim=-1, keepdim=True)

    def ranges(length):
        n = -(-length // tile)
        parts = min(splits, n)
        return [(i * n // parts * tile, min((i + 1) * n // parts * tile, length))
                for i in range(parts)]

    def ds_p(qs, ks):  # dS and P of query rows qs and keys ks
        p = torch.exp(torch.matmul(qh[:, :, qs], kh[:, :, ks].transpose(-1, -2)) * scale
                      - lh[:, :, qs])
        dp = torch.matmul(doh[:, :, qs], vh[:, :, ks].transpose(-1, -2))
        return (p * (dp - drow[:, :, qs]) * scale).to(dtype).float(), p

    everything = slice(None)
    dq = sum(torch.matmul(ds_p(everything, slice(lo, hi))[0], kh[:, :, lo:hi])
             for lo, hi in ranges(k.shape[1]))
    dk = dv = 0
    for lo, hi in ranges(q.shape[1]):
        ds, p = ds_p(slice(lo, hi), everything)
        dk = dk + torch.matmul(ds.transpose(-1, -2), qh[:, :, lo:hi])
        dv = dv + torch.matmul(p.to(dtype).float().transpose(-1, -2), doh[:, :, lo:hi])
    return _packed(dq, dtype), _packed(dk, dtype), _packed(dv, dtype)


def kernel_tiles(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernels' 64-row tiles cover Sq and Sk (multiples of 64,
    of any length). The backward takes a shape only then; otherwise autograd
    recomputes through the plain version, as the TPU package does where
    ``_bwd_kernel_applicable`` is false (kv=77 cross-attention)."""
    return all(s % BLOCK == 0 and s > 0 for s in (q.shape[1], k.shape[1]))


def _check_cuda_inputs(q, k, v, num_heads, whole_tiles: bool = True) -> None:
    """The checks before a launch: B2b's (``whole_tiles``: Sq and Sk
    multiples of 64), or B1's and B2a's, which take any lengths."""
    b, sq, c = q.shape
    sk = k.shape[1]
    fa.check_dtypes(q, ("k", k), ("v", v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != (b, sk, c) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"channels {c} do not split into {num_heads} heads")
    fa.check_head_dim(c // num_heads)
    if whole_tiles:
        _check_seq(sq, sk)


def _device(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _plan_for(b: int, sq: int, sk: int, h: int, d: int, *, dtype=torch.bfloat16):
    """The plan a B1 or B2a call launches: ``forward_plan``'s on bf16,
    ``fa.f32_plan``'s on f32 (``tune_kernels`` and the card tests swap in
    others)."""
    if dtype == torch.float32:
        return fa.f32_plan(b, sq, sk, h, d)
    return forward_plan(b, sq, sk, h, d)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    # pointers, then (B, Sq, Sk, heads, padded d, d) and the plan's (nwg, bn,
    # stages, splits), then the stream
    lib.packed_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_fwd_lse.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_fwd.restype = lib.packed_attention_fwd_lse.restype = ctypes.c_int
    lib.packed_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.packed_attention_smem_bytes.restype = ctypes.c_int
    lib.packed_attention_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_error_string.restype = ctypes.c_char_p
    # f32: q, k, v, o, lse (or null), then (B, Sq, Sk, heads, padded d, d),
    # the plan's (nwg, bn, stages, splits), the stream
    lib.packed_attention_fwd_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_fwd_f32.restype = ctypes.c_int
    lib.packed_attention_f32_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.packed_attention_f32_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("packed_attention_bwd")
    # pointers, then (B, Sq, Sk, heads, padded d, d), then the stream
    lib.packed_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_bwd.restype = ctypes.c_int
    lib.packed_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.packed_attention_bwd_smem_bytes.restype = ctypes.c_int
    lib.packed_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_bwd_error_string.restype = ctypes.c_char_p
    # f32: ten pointers, (B, Sq, Sk, heads, padded d, d), the stream
    lib.packed_attention_bwd_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.packed_attention_bwd_f32.restype = ctypes.c_int
    lib.packed_attention_bwd_f32_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.packed_attention_bwd_f32_smem_bytes.restype = ctypes.c_int
    return lib


def _raise_on(rc: int, what: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(rc).decode()} ({rc})")


def _count(fn, q: torch.Tensor, k: torch.Tensor) -> None:
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
        fn.launches += 1
        fn.launches_by_shape[(q.shape[0], q.shape[1], k.shape[1], q.shape[2])] += 1


def _launch_forward(q, k, v, num_heads, with_lse: bool):
    _check_cuda_inputs(q, k, v, num_heads, whole_tiles=False)
    if q.dtype == torch.float32:
        return _launch_forward_f32(q, k, v, num_heads, with_lse)
    b, sq, c = q.shape
    d = c // num_heads
    p = _plan_for(b, sq, k.shape[1], num_heads, d)
    qp, kp, vp = (fa.pad_heads(x, d) for x in (q, k, v))
    out = torch.empty_like(qp)
    lse = torch.empty(b, sq, num_heads, device=q.device, dtype=torch.float32) if with_lse else None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr())
        dims = (b, sq, k.shape[1], num_heads, fa.padded_head_dim(d), d, p.nwg, p.bn, p.stages,
                p.splits, stream)
        if with_lse:
            rc = lib.packed_attention_fwd_lse(*args, lse.data_ptr(), *dims)
        else:
            rc = lib.packed_attention_fwd(*args, *dims)
    _count(packed_attention_forward_lse if with_lse else packed_flash_attention, q, k)
    _raise_on(rc, "packed_attention_fwd" + ("_lse" if with_lse else ""),
              lib.packed_attention_error_string)
    out = fa.unpad_heads(out, d)
    return (out, lse) if with_lse else out


def _launch_forward_f32(q, k, v, num_heads, with_lse: bool):
    """B1 or B2a on f32: the 3xTF32 kernel of ``csrc/attention_f32_hopper.cuh``
    (``fa.f32_plan``); a head dim off a multiple of 4 zero-padded first."""
    b, sq, c = q.shape
    d = c // num_heads
    dp = fa.f32_padded_head_dim(d)
    qp, kp, vp = (fa.pad_heads(x, d, dp) for x in (q, k, v))
    out = torch.empty_like(qp)
    lse = torch.empty(b, sq, num_heads, device=q.device, dtype=torch.float32) if with_lse else None
    p = _plan_for(b, sq, k.shape[1], num_heads, d, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.packed_attention_fwd_f32(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                          out.data_ptr(), lse.data_ptr() if with_lse else None,
                                          b, sq, k.shape[1], num_heads, dp, d, p.nwg, p.bn,
                                          p.stages, p.splits, stream)
    _count(packed_attention_forward_lse if with_lse else packed_flash_attention, q, k)
    _raise_on(rc, "packed_attention_fwd_f32", lib.packed_attention_error_string)
    out = fa.unpad_heads(out, d, dp)
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
    b, sq, c = q.shape
    d = c // num_heads
    if q.dtype == torch.float32:
        return _launch_backward_f32(q, k, v, o, lse, do, num_heads)
    qp, kp, vp, op, dop = (fa.pad_heads(x, d) for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    # L * log2(e) and rowsum(dO * O) as (B, heads, Sq), written by the first
    # kernel for the second
    delta = torch.empty(2, b, num_heads, sq, device=q.device, dtype=torch.float32)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.packed_attention_bwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(), lse.data_ptr(),
            dop.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], num_heads, fa.padded_head_dim(d), d, stream,
        )
    _count(packed_attention_backward, q, k)
    _raise_on(rc, "packed_attention_bwd", lib.packed_attention_bwd_error_string)
    return tuple(fa.unpad_heads(x, d) for x in (dq, dk, dv))


def _launch_backward_f32(q, k, v, o, lse, do, num_heads):
    """B2b on f32: the two 3xTF32 kernels of ``csrc/packed_attention_bwd.cu``
    (``backward_plan(..., dtype=torch.float32)``); a head dim off a multiple
    of 4 zero-padded first."""
    b, sq, c = q.shape
    d = c // num_heads
    dp = fa.f32_padded_head_dim(d)
    qp, kp, vp, op, dop = (fa.pad_heads(x, d, dp) for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    # L * log2(e) and rowsum(dO * O) as (B, heads, Sq), written by the first
    # kernel for the second
    delta = torch.empty(2, b, num_heads, sq, device=q.device, dtype=torch.float32)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.packed_attention_bwd_f32(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(), lse.data_ptr(),
            dop.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, k.shape[1], num_heads, dp, d, stream,
        )
    _count(packed_attention_backward, q, k)
    _raise_on(rc, "packed_attention_bwd_f32", lib.packed_attention_bwd_error_string)
    return tuple(fa.unpad_heads(x, d, dp) for x in (dq, dk, dv))


class PackedFlashAttention(torch.autograd.Function):
    """Counterpart of the TPU package's ``custom_vjp`` (``_fwd``/``_bwd``):
    the forward runs B2a and saves q, k, v, o and L; the backward runs B2b.
    A shape the kernels cannot tile (``kernel_tiles`` false) runs the plain
    forward and recomputes its gradient through the plain version's
    autograd, counted in ``PackedFlashAttention.fallbacks``: the forward is
    still B1's kernel (on the card), as JAX's ``_fwd`` runs its kernel."""

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
