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
  (B, S, H, D) in place with row stride H*D; the JAX wrapper's
  transposes to (B*H, S, D) are a TPU tiling artifact and are not ported.
  On f32 q, k and v it launches ``csrc/attention_f32_hopper.cuh``'s
  forward instead (3xTF32 on the tensor cores: S = Q K^T on wgmma, O += P V
  on mma.sync; f32 out, as the TPU kernel writes q's dtype; ``f32_plan``
  gives its blocks; a D that is not a multiple of 4 zero-padded to the next
  one): no bf16 round trip.
  Takes bf16 or f32 and every head dim D >= 1 (SD-1.5's 40/80/160 among
  them), read as ceil(D / 64) atoms of 64 columns; a D that is not a
  multiple of 8 is zero-padded to the next one in a scratch copy first
  (TMA needs 16-byte row strides), the kernel scaled by the real D, and only
  the D real columns are kept. Above four atoms (D > 256: five atoms of f32
  O would pass a thread's 255 registers at 64 rows) the wide kernels take
  the head (``wide_plan``, ``f32_plan``): at five or six atoms the paired
  kernel (two warpgroups of three atoms of O sharing every K and V load),
  else O in ``wide_chunking``'s chunks of three or four atoms, one a block,
  S summed over every atom streamed through a ring; in f32 from
  nine to sixteen atoms the clustered kernel (chunks of two atoms the CTAs
  of a cluster, exchanging partial S); the keys split where the grid is
  short. Bound: tensor-core operations for long self-attention, bytes for
  cross-attention over 77 keys.
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

HEAD_DIM = 64  # the head dim of the sd-turbo / SDXL geometry, the plans' default
ATOM = 64  # columns of a head atom: the kernels read a head as ceil(d / 64) of them
NARROW_ATOMS = 4  # the most atoms a block holds O for (d <= 256): five would hold 160 f32 a thread


def head_atoms(d: int) -> int:
    """64-column atoms of a head of ``d`` columns (mirrors ``head_atoms`` in
    ``csrc/attention_hopper.cuh``)."""
    return -(-d // ATOM)


def padded_head_dim(d: int) -> int:
    """The columns the kernels read a head of ``d`` as: the next multiple
    of 8 (TMA's 16-byte row strides); the wrappers zero-pad to it."""
    return -(-d // 8) * 8


def check_head_dim(d: int) -> None:
    """Raises for a head dim the attention kernels do not take: below 1.
    Every d >= 1 is taken (above ``NARROW_ATOMS`` atoms by the wide
    kernels, whose shared memory does not grow with d)."""
    if d < 1:
        raise ValueError(f"head_dim {d} must be at least 1")


def wide_chunking(atoms: int) -> tuple[int, int]:
    """(chunks, atoms a chunk) of O's columns for a head of ``atoms`` >
    ``NARROW_ATOMS`` atoms: as few chunks of at most four atoms as cover
    it, evened out (5 atoms: 2 chunks of 3; 10: 3 of 4; 16: 4 of 4). Mirrors
    ``wide_chunks`` / ``wide_chunk_atoms`` in ``csrc/attention_hopper.cuh``."""
    chunks = -(-atoms // NARROW_ATOMS)
    return chunks, -(-atoms // chunks)


def pad_heads(x: torch.Tensor, d: int, dp: int | None = None) -> torch.Tensor:
    """(..., heads * d) or (..., d) -> the same with each head zero-padded
    to ``dp`` columns (``padded_head_dim(d)`` unless given; a new contiguous
    tensor), or ``x`` itself when dp is d."""
    dp = padded_head_dim(d) if dp is None else dp
    if dp == d:
        return x
    heads = x.shape[-1] // d
    return torch.nn.functional.pad(x.reshape(*x.shape[:-1], heads, d), (0, dp - d)).reshape(
        *x.shape[:-1], heads * dp)


def unpad_heads(x: torch.Tensor, d: int, dp: int | None = None) -> torch.Tensor:
    """Undoes ``pad_heads``: the d real columns of each head, contiguous."""
    dp = padded_head_dim(d) if dp is None else dp
    if dp == d:
        return x
    heads = x.shape[-1] // dp
    # contiguous: at d = 1, or one head, the reshape alone can give a strided view
    return x.reshape(*x.shape[:-1], heads, dp)[..., :d].reshape(
        *x.shape[:-1], heads * d).contiguous()


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
SMEM_BLOCK = 232448  # dynamic shared memory a block may ask for (227 KB)
REGISTERS_SM = 65536
# (consumer warpgroups of 64 query rows, keys a K/V tile): the kernel's
# instantiations at head dims up to 64 (one atom)
TILES = ((1, 64), (1, 80), (1, 128), (2, 64), (2, 80), (2, 128), (3, 128))
# and at 72..192 (two or three atoms): one block an SM, whose O accumulator
# (32 registers a thread an atom) and K/V stages grow with the atoms
WIDE_TILES = ((1, 64), (1, 80), (2, 64))
# and at 200..256 (four atoms): 128 f32 of O a thread, so one consumer
# warpgroup beside a one-warp producer (160 threads: up to 255 registers)
WIDEST_TILES = ((1, 64), (1, 80))
# and above 256 (the wide kernels, B1/B2a's and B3's alike), on 64-key
# tiles: at five or six atoms (d = 264..384) the paired kernel, two consumer
# warpgroups of the same 64 rows, ``PAIR_ATOMS`` atoms of O each, both
# forming S over the whole head, Q resident, a ring of ``pair_stages`` 48 KB
# items (over more than ``PAIR_MIN_TILES`` key tiles); else the streaming
# kernel, one consumer warpgroup and a ring of ``WIDE_STAGES`` 32 KB slots
# (four 64-row atom tiles); both split the keys where the grid is short
# (``key_splits``)
WIDE_HEAD_TILES = ((1, 64), (2, 64))
WIDE_SLOT_BYTES = 4 * 64 * 128
WIDE_STAGES = 6  # the ring's slots (kMaxWideStages in csrc/attention_hopper.cuh)
ATOM_TILE_BYTES = 64 * 128  # 64 rows of one bf16 atom
PAIR_ATOMS = 3  # kPairAtoms in csrc/attention_fwd_hopper.cuh: atoms of O a warpgroup
MAX_SPLITS = 4  # key ranges a launch (kMaxSplits): CTAs a cluster
MIN_SPLIT_TILES = 2  # key tiles a range at least: a merge costs a few microseconds
PAIR_MIN_TILES = 2  # key tiles up to which the streaming kernel takes five or six atoms
MAX_STAGES = 4
LONG_KEY_LOOP = 4  # K/V tiles from which two or three consumer warpgroups pay
# time per 64 query rows of a three-warpgroup block against a two-warpgroup
# one, both one block an SM (tune_kernels packed, H100: 1x4096, 5 heads,
# 0.0515 ms in one wave of 192-row blocks against 0.0759 in two of 128)
THREE_WG_ROW_COST = 0.9


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: ``nwg`` consumer warpgroups (64 query rows each),
    ``bn`` keys a K/V tile, a ring of ``stages`` K/V stages, heads of
    ``atoms`` 64-column atoms."""

    nwg: int
    bn: int
    stages: int
    kv_tiles: int
    grid: tuple[int, int, int]  # (query tiles, heads, batch)
    smem_bytes: int
    why_short: str  # why the grid is under one wave ("" if it is not)
    atoms: int = 1
    chunks: int = 1  # O's column chunks, one a block (the wide kernel, above four atoms)
    splits: int = 1  # key ranges of the wide kernels where the grid is short: a cluster

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def cluster(self) -> int:
        """CTAs a thread-block cluster: the wide kernels' key splits."""
        return self.splits

    @property
    def rows(self) -> int:
        """Query rows a block (the paired kernel's two warpgroups share theirs)."""
        return 64 if self.atoms > NARROW_ATOMS else 64 * self.nwg

    @property
    def threads(self) -> int:
        # + the producer: one warp beside one consumer warpgroup, else a
        # warpgroup (setmaxnreg moves registers by warpgroup)
        return 128 * self.nwg + (32 if self.nwg == 1 else 128)

    @property
    def blocks_per_sm(self) -> int:
        """The kernel's launch bounds: the one-warpgroup, 64-key block of a
        one-atom head is held to 136 registers a thread so that three share
        an SM."""
        return 3 if (self.nwg, self.bn, self.atoms) == (1, 64, 1) else 1

    @property
    def max_registers(self) -> int:
        """Registers a thread may hold at launch (ptxas's cap from the
        launch bounds; with setmaxnreg the consumers of a 384-thread block
        then take 240, those of a 512-thread block 160)."""
        return min(255, REGISTERS_SM // (self.threads * self.blocks_per_sm) // 8 * 8)


def smem_bytes(nwg: int, bn: int, stages: int, atoms: int = 1) -> int:
    """Dynamic shared memory of one block: 1 KB of alignment slack, the Q
    tile, the K/V ring and the barriers (above four atoms the paired
    kernel's, ``pair_smem_bytes``, or the streaming kernel's ring of slots
    and its barriers, whatever the atoms). Mirrors ``fwd_smem_bytes`` /
    ``pair_fwd_smem_bytes`` / ``wide_fwd_smem_bytes`` in
    ``csrc/attention_fwd_hopper.cuh``, which ``flash_attention_smem_bytes``
    and ``packed_attention_smem_bytes`` return."""
    if atoms > NARROW_ATOMS:
        if nwg == 2:
            return pair_smem_bytes(stages)
        return 1024 + stages * WIDE_SLOT_BYTES + 16 * stages
    return 1024 + (64 * nwg * 128 + stages * 2 * bn * 128) * atoms + 16 * stages + 16


def paired(atoms: int) -> bool:
    """Whether a head of ``atoms`` atoms fits the paired wide kernel: five
    or six (d = 264..384), two warpgroups of ``PAIR_ATOMS`` atoms of O."""
    return NARROW_ATOMS < atoms <= 2 * PAIR_ATOMS


def wide_warpgroups(atoms: int, sk: int) -> int:
    """The wide kernel a head of ``atoms`` > ``NARROW_ATOMS`` atoms over
    ``sk`` keys takes, by its consumer warpgroups: 2, the paired kernel, at
    five or six atoms and more than ``PAIR_MIN_TILES`` key tiles; else 1,
    the streaming kernel, which measured faster over the 77 prompt keys
    (1x4096x77 at d = 320: 0.00905 ms against 0.01376 with the keys split;
    H100)."""
    return 2 if paired(atoms) and -(-sk // 64) > PAIR_MIN_TILES else 1


def pair_smem_bytes(stages: int) -> int:
    """Shared memory of a paired block: alignment slack, Q's six atoms,
    ``stages`` K or V items of six atoms, the barriers. Mirrors
    ``pair_fwd_smem_bytes``."""
    return 1024 + (1 + stages) * 2 * PAIR_ATOMS * ATOM_TILE_BYTES + 8 * (2 * stages + 1)


def pair_stages() -> int:
    """The paired kernel's ring: as many 48 KB items as shared memory leaves
    (three; ``pair_fwd_stages``)."""
    return max([2] + [s for s in range(2, WIDE_STAGES + 1) if pair_smem_bytes(s) <= SMEM_BLOCK])


def pair_merge_fits(stages: int) -> bool:
    """Whether a paired block's ring holds what a key split leaves for the
    merge: each consumer thread's O, m and l as float4s."""
    return stages * 2 * PAIR_ATOMS * ATOM_TILE_BYTES >= (8 * PAIR_ATOMS + 1) * 256 * 16


def tiles_for(d: int) -> tuple:
    """B3's instantiations at head dim ``d``."""
    atoms = head_atoms(d)
    if atoms > NARROW_ATOMS:
        return WIDE_HEAD_TILES
    return {1: TILES, 4: WIDEST_TILES}.get(atoms, WIDE_TILES)


def _check_shape(b: int, sq: int, sk: int, h: int) -> None:
    if min(b, sq, sk, h) < 1:
        raise ValueError(f"empty attention: B={b}, Sq={sq}, Sk={sk}, heads={h}")


@functools.lru_cache(maxsize=None)
def plan(b: int, sq: int, sk: int, h: int, d: int = HEAD_DIM, sms: int = SMS) -> Plan:
    """Consumer warpgroups, key tile and ring depth for a (B, Sq, Sk, heads)
    call at head dim ``d``, by the rules ``python -m genima_torch.tune_kernels
    attn`` chose at d = 64:

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

    Two- and three-atom heads (d = 72..192) take 64-key tiles (80 for the
    prompt), two warpgroups for a key loop of ``LONG_KEY_LOOP`` tiles or
    more, and as deep a ring as shared memory leaves (three stages for two
    warpgroups at three atoms); four-atom heads (d = 200..256) the same
    tiles with one warpgroup (three stages of 64 keys, two of 80); wider
    heads the wide kernel (``wide_plan``).
    """
    _check_shape(b, sq, sk, h)
    check_head_dim(d)
    atoms = head_atoms(d)
    if atoms > NARROW_ATOMS:
        return wide_plan(b, sq, sk, h, d, sms)
    if atoms > 1:
        bn = 80 if 64 < sk <= 80 else 64
        nwg = 2 if atoms < 4 and -(-sk // bn) >= LONG_KEY_LOOP else 1
        return make_plan(b, sq, sk, h, nwg, bn, d=d, sms=sms)
    bn = 64 if sk <= 64 else 80 if sk <= 80 else 128
    nwg = long_loop_warpgroups(b, sq, h, sms) if -(-sk // bn) >= LONG_KEY_LOOP else 1
    return make_plan(b, sq, sk, h, nwg, bn, d=d, sms=sms)


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


def key_splits(blocks: int, kv_tiles: int, sms: int = SMS) -> int:
    """Key ranges of the wide kernels: 1 where ``blocks`` fill the card;
    where they do not, as many as keep the grid within one wave, each range
    ``MIN_SPLIT_TILES`` key tiles at least, ``MAX_SPLITS`` at most (1x4096
    in one head at d = 320: 64 blocks, two ranges; 1x1024 at d = 640: 48
    blocks, two; the 77 prompt keys, two tiles: none)."""
    if blocks >= sms:
        return 1
    return max(k for k in range(1, MAX_SPLITS + 1)
               if k == 1 or (k * MIN_SPLIT_TILES <= kv_tiles and blocks * k <= sms))


def wide_plan(b: int, sq: int, sk: int, h: int, d: int, sms: int = SMS) -> Plan:
    """The wide kernels' launch (heads of more than four atoms; B1, B2a and
    B3 alike) on 64-key tiles, the keys split ``key_splits`` ways where the
    grid is short: where ``wide_warpgroups`` gives two, the paired kernel,
    two consumer warpgroups of 64 query rows, one block per (64 rows, key
    range, head, batch), a ring of ``pair_stages`` items; else the streaming
    kernel, one warpgroup, one block per (64 rows, chunk of O's columns,
    key range, head, batch), ``WIDE_STAGES`` 32 KB slots (192 KB whatever d
    is)."""
    return make_plan(b, sq, sk, h, wide_warpgroups(head_atoms(d), sk), 64, sms=sms,
                     tiles=WIDE_HEAD_TILES, d=d)


def max_stages(nwg: int, bn: int, atoms: int) -> int:
    """The deepest ring (at most ``MAX_STAGES``) a block's shared memory
    holds."""
    return max(s for s in range(1, MAX_STAGES + 1)
               if s == 1 or smem_bytes(nwg, bn, s, atoms) <= SMEM_BLOCK)


def make_plan(b: int, sq: int, sk: int, h: int, nwg: int, bn: int, stages: int | None = None,
              sms: int = SMS, tiles=None, d: int = HEAD_DIM) -> Plan:
    """The launch for a chosen tile of ``tiles`` (the instantiations of the
    kernel's source, by default B3's at head dim ``d``); the ring depth as
    ``plan`` derives it unless given."""
    _check_shape(b, sq, sk, h)
    check_head_dim(d)
    atoms = head_atoms(d)
    if (nwg, bn) not in (tiles_for(d) if tiles is None else tiles):
        raise ValueError(f"no kernel for {nwg} warpgroups x {bn}-key tiles at head_dim {d}")
    kv_tiles = -(-sk // bn)
    pair = atoms > NARROW_ATOMS and nwg == 2
    if pair and not paired(atoms):
        raise ValueError(f"no wide kernel for {nwg} warpgroups at head_dim {d}")
    if pair:
        # the paired kernel's ring is as deep as shared memory leaves
        chunks, fewest = 1, pair_stages()
        deepest = fewest
        stages = deepest if stages is None else stages
    elif atoms > NARROW_ATOMS:
        # the streaming kernel's ring holds a slot across key tiles: two at least
        chunks, fewest, deepest = wide_chunking(atoms)[0], 2, WIDE_STAGES
        stages = WIDE_STAGES if stages is None else stages
    else:
        # a stage goes back to the producer only once the next tile has arrived
        chunks, fewest, deepest = 1, 2 if kv_tiles > 1 else 1, max_stages(nwg, bn, atoms)
        stages = min(kv_tiles, deepest) if stages is None else stages
    if not fewest <= stages <= deepest:
        raise ValueError(f"{stages} stages for {kv_tiles} K/V tiles at head_dim {d}")
    rows = 64 if atoms > NARROW_ATOMS else 64 * nwg  # the paired kernel's warpgroups share rows
    tiles = -(-sq // rows)
    blocks = tiles * chunks * h * b
    why = ""
    if blocks < sms:
        why = f"{tiles} tiles of {rows} query rows x {h} heads x batch {b}"
        if chunks > 1:
            why += f" x {chunks} column chunks"
        if pair:
            why += ", 2 warpgroups splitting O's columns"
        elif nwg > 1:
            why += f", {nwg} warpgroups sharing each of {kv_tiles} K/V tiles"
    splits = key_splits(blocks, kv_tiles, sms) if atoms > NARROW_ATOMS else 1
    if splits > 1:
        why += f"; keys split {splits} ways"
    return Plan(nwg=nwg, bn=bn, stages=stages, kv_tiles=kv_tiles,
                grid=(tiles * chunks * splits, h, b),
                smem_bytes=smem_bytes(nwg, bn, stages, atoms), why_short=why, atoms=atoms,
                chunks=chunks, splits=splits)


F32_SLAB_BYTES = 128  # 32 f32 columns: one TMA box and swizzle span of the f32 kernels
F32_PRODUCER = 128  # the f32 kernels' producer warpgroup (TMA and the 3xTF32 splitters)


def f32_padded_head_dim(d: int) -> int:
    """The columns the f32 kernels read a head of ``d`` as: the next
    multiple of 4 (TMA's 16-byte row strides and column offsets); the
    wrappers zero-pad to it."""
    return -(-d // 4) * 4


# (consumer warpgroups of 64 query rows, keys a K/V tile): the f32
# forward's instantiations per atom count (``fwd_tile_ok`` in
# ``csrc/attention_f32_hopper.cuh``); the 80-key tile, for B3's 77 prompt
# keys, is built into flash_attention.cu only
F32_TILES = {1: ((2, 64), (1, 80)), 2: ((2, 32),), 3: ((1, 32),), 4: ((1, 16),)}
# above four atoms the wide f32 kernels: one consumer warpgroup on 32-key
# tiles. At 9 to 16 atoms (d = 516..1024) the clustered kernel: chunks of
# ``F32_CLUSTER_ATOMS`` atoms, the CTAs of a cluster exchanging partial
# scores, Q's two atoms resident, a ring of 32 KB slots (a K item split, or
# a V item raw) as deep as shared memory leaves (``f32_cluster_stages``);
# else the streaming kernel's ``WIDE_STAGES`` slots (64 query rows of an
# atom raw and a tile's 32 keys of it split, or a tile of the chunk's atoms)
# over ``wide_chunking``'s chunks
F32_WIDE_TILE = (1, 32)
F32_CLUSTER_ATOMS = 2  # kClusterAtomsF32 in csrc/attention_f32_hopper.cuh
F32_CLUSTER_CHUNKS = 8  # kClusterChunksF32: a portable cluster
F32_EXCHANGE_BYTES = 64 * 32 * 4  # one partial S, 64 rows x 32 keys (kXBytesF32)


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """One call of the f32 forward (``csrc/attention_f32_hopper.cuh``,
    3xTF32): blocks of ``rows`` = 64 * ``nwg`` query rows (consumer
    warpgroups beside a producer warpgroup) over (tiles, heads, batch), K/V
    tiles of ``bn`` keys in a ring of ``stages``, a head read as ``atoms``
    64-column atoms."""

    nwg: int
    bn: int
    stages: int
    grid: tuple[int, int, int]
    smem_bytes: int
    atoms: int
    why_short: str  # why the grid is under one wave ("" if it is not)
    chunks: int = 1  # O's column chunks, one a block (the wide kernel, above four atoms)
    splits: int = 1  # key ranges: the f32 kernels never split

    @property
    def rows(self) -> int:
        return 64 * self.nwg

    @property
    def cluster(self) -> int:
        """CTAs a thread-block cluster: the chunks for the clustered wide
        kernel, else 1."""
        return self.chunks if f32_clustered(self.atoms) else 1

    @property
    def threads(self) -> int:
        return 128 * self.nwg + F32_PRODUCER

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def f32_smem_bytes(nwg: int, bn: int, stages: int, atoms: int) -> int:
    """Dynamic shared memory of an f32 forward block: alignment slack, the Q
    tile, a ring of (K, K's remainders, V) tiles and its barriers. Mirrors
    ``fwd_smem_bytes`` in ``csrc/attention_f32_hopper.cuh``, which
    ``flash_attention_f32_smem_bytes`` and ``packed_attention_f32_smem_bytes``
    return."""
    if f32_clustered(atoms):
        return f32_cluster_smem_bytes(f32_wide_chunking(atoms)[0], stages)
    if atoms > NARROW_ATOMS:
        return f32_wide_smem_bytes(stages, rows=False)
    slabs = 2 * atoms
    return (1024 + 64 * nwg * slabs * F32_SLAB_BYTES + stages * 3 * bn * slabs * F32_SLAB_BYTES
            + 8 * (3 * stages + 1))


def f32_wide_smem_bytes(stages: int, rows: bool) -> int:
    """Shared memory of a wide f32 block (the forward, or B2b's dq and, with
    ``rows``, dk/dv kernels): alignment slack, a ring of 32 KB slots (the
    dk/dv kernels' with a tile's 32 values of L * log2(e) and Drow) and
    three barriers a slot. Mirrors ``wide_smem_bytes`` in
    ``csrc/attention_f32_hopper.cuh``."""
    return 1024 + stages * (WIDE_SLOT_BYTES + (2 * 32 * 4 if rows else 0)) + 24 * stages


def f32_wide_chunking(atoms: int) -> tuple[int, int]:
    """(chunks, atoms a chunk) of the f32 wide forward's O: the clustered
    kernel's chunks of ``F32_CLUSTER_ATOMS`` atoms, else ``wide_chunking``'s."""
    if f32_clustered(atoms):
        return -(-atoms // F32_CLUSTER_ATOMS), F32_CLUSTER_ATOMS
    return wide_chunking(atoms)


def f32_clustered(atoms: int) -> bool:
    """Whether an f32 head of ``atoms`` atoms takes the clustered wide
    forward: 9 to 16 (d = 516..1024; ``f32_clustered`` in the source). At 5
    to 8 the streaming kernel measured faster (1x4096 at d = 320: 0.828 ms
    against 1.08; H100)."""
    return 2 * NARROW_ATOMS < atoms and -(-atoms // F32_CLUSTER_ATOMS) <= F32_CLUSTER_CHUNKS


def f32_cluster_smem_bytes(chunks: int, stages: int) -> int:
    """Shared memory of a clustered f32 block: alignment slack, Q's four
    slabs of 64 rows, ``stages`` 32 KB slots, two out buffers and two
    exchange buffers a peer, three barriers a slot and three more. Mirrors
    ``cluster_smem_bytes_f32`` in ``csrc/attention_f32_hopper.cuh``."""
    return (1024 + 64 * 4 * F32_SLAB_BYTES + stages * WIDE_SLOT_BYTES
            + 2 * chunks * F32_EXCHANGE_BYTES + 8 * (3 * stages + 3))


def f32_cluster_stages(chunks: int) -> int:
    """The clustered f32 kernel's ring: as many slots as shared memory
    leaves, at most ``WIDE_STAGES`` (``cluster_stages_f32``): 3 at five and
    six chunks (d = 516..768), 2 at seven and eight (769..1024)."""
    return max([2] + [s for s in range(2, WIDE_STAGES + 1)
                      if f32_cluster_smem_bytes(chunks, s) <= SMEM_BLOCK])


F32_STAGES = 2  # the f32 forward's ring: deeper rings measured no faster at the SD shapes


@functools.lru_cache(maxsize=None)
def f32_plan(b: int, sq: int, sk: int, h: int, d: int = HEAD_DIM, sms: int = SMS, *,
             key80: bool = False) -> F32Plan:
    """The f32 forward's launch for a (B, Sq, Sk, heads) call at head dim
    ``d``: one atom two consumer warpgroups (128 query rows) on 64-key
    tiles, or with ``key80`` (B3, whose library has the 80-key tile) one
    warpgroup on one 80-key tile for up to 80 keys; two to four atoms their
    one tile. A ring of two stages (one where there is one K/V tile). Above
    four atoms the wide kernels: ``F32_WIDE_TILE``, a block per (64 rows,
    chunk of O's columns, head, batch) over ``f32_wide_chunking``'s chunks;
    the clustered kernel's ``f32_cluster_stages`` slots, the streaming
    kernel's ``WIDE_STAGES``."""
    _check_shape(b, sq, sk, h)
    check_head_dim(d)
    atoms = head_atoms(f32_padded_head_dim(d))
    chunks = 1
    if atoms > NARROW_ATOMS:
        (nwg, bn), chunks = F32_WIDE_TILE, f32_wide_chunking(atoms)[0]
        stages = f32_cluster_stages(chunks) if f32_clustered(atoms) else WIDE_STAGES
    else:
        nwg, bn = (1, 80) if atoms == 1 and key80 and sk <= 80 else F32_TILES[atoms][0]
        stages = min(F32_STAGES, -(-sk // bn))
    grid = (-(-sq // (64 * nwg)) * chunks, h, b)
    blocks = grid[0] * h * b
    why = ""
    if blocks < sms:
        why = f"{grid[0] // chunks} tiles of {64 * nwg} query rows x {h} heads x batch {b}"
        if chunks > 1:
            why += f" x {chunks} column chunks"
    return F32Plan(nwg=nwg, bn=bn, stages=stages, grid=grid,
                   smem_bytes=f32_smem_bytes(nwg, bn, stages, atoms), atoms=atoms,
                   why_short=why, chunks=chunks)


def _plan_for(b: int, sq: int, sk: int, h: int, d: int, *, dtype=torch.bfloat16):
    """The plan a call launches: ``plan``'s on bf16, ``f32_plan``'s on f32
    (``tune_kernels`` and the card tests swap in others)."""
    if dtype == torch.float32:
        return f32_plan(b, sq, sk, h, d, key80=True)
    return plan(b, sq, sk, h, d)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    # pointers, then (B, Sq, Sk, heads, padded d, d) and the plan's (nwg, bn,
    # stages, splits), then the stream
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    # f32: pointers, (B, Sq, Sk, heads, padded d, d), the plan's (nwg, bn,
    # stages, splits), the stream
    lib.flash_attention_fwd_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.flash_attention_fwd_f32.restype = ctypes.c_int
    lib.flash_attention_f32_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_f32_smem_bytes.restype = ctypes.c_int
    return lib


CUDA_DTYPES = (torch.bfloat16, torch.float32)  # what the attention kernels take


def check_dtypes(q: torch.Tensor, *others: tuple[str, torch.Tensor]) -> None:
    """Raises unless q is bf16 or f32 and each named tensor has q's dtype."""
    if q.dtype not in CUDA_DTYPES:
        raise ValueError(f"q must be bfloat16 or float32 on CUDA, got {q.dtype}")
    for name, x in others:
        if x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} as q is (bfloat16 or float32 on "
                             f"CUDA), got {x.dtype}")


def _check_cuda_inputs(q, k, v) -> None:
    b, _, h, d = q.shape
    check_dtypes(q, ("k", k), ("v", v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape or k.shape[1] < 1:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    check_head_dim(d)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    lib = _library()
    f32 = q.dtype == torch.float32
    dp = f32_padded_head_dim(d) if f32 else padded_head_dim(d)
    qp, kp, vp = (pad_heads(x, d, dp) for x in (q, k, v))
    out = torch.empty_like(qp)
    # the 3xTF32 kernel on f32, the bf16 one otherwise
    if f32:
        p, launch = _plan_for(b, sq, k.shape[1], h, d, dtype=q.dtype), lib.flash_attention_fwd_f32
    else:
        p, launch = _plan_for(b, sq, k.shape[1], h, d), lib.flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), b, sq,
                    k.shape[1], h, dp, d, p.nwg, p.bn, p.stages, p.splits, stream)
    with _build.COUNT_LOCK:  # mesh rows launch from several threads
        flash_attention.launches += 1
        flash_attention.launches_by_shape[(b, sq, k.shape[1], h * q.shape[-1])] += 1
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: {lib.flash_attention_error_string(rc).decode()} ({rc})")
    return unpad_heads(out, d, dp)


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
