"""The launch plans of the port's B1/B2a, B2b, B3, B4 and B5 kernels: pure
Python, so they are held here on the CPU at every shape of the serving
paths and the trainer's attention levels (the kernels themselves are tested
on the card in test_torch_cuda_kernels.py).
"""

import contextlib
import re
import types
from pathlib import Path

import pytest
import torch

from chip_smoke import (BATCHED_CONV_SHAPES, BATCHED_FLASH_SHAPES, BATCHED_W8_SHAPES,
                        CONV_SHAPES, FLASH_SHAPES, SD_LEVELS, TRAIN_LEVELS, W8_SHAPES,
                        WIDE_SWEEP_DIMS, _sweep_heads)
from genima_torch.kernels import flash_attention as fa
from genima_torch.kernels import fused_conv as fc
from genima_torch.kernels import packed_attention as pa
from genima_torch.kernels import w8_matmul as w8

# what the H100 gives one block: 227 KB of shared memory
SMEM_LIMIT = 232448

# shapes the card tests add to the path's: one token, K that is not a
# multiple of the 128-wide K tile, N of one 8-column group
W8_EXTRA = [(1, 1024, 8), (77, 1040, 320), (256, 1040, 1280), (5, 48, 24)]
# the serving path's shapes, then those of the lockstep-batched eval (4 envs)
W8_PLAN_SHAPES = list(dict.fromkeys(W8_SHAPES + BATCHED_W8_SHAPES + W8_EXTRA))


@pytest.mark.parametrize("m,k,n", W8_PLAN_SHAPES)
def test_w8_plan_fills_the_card_or_says_why(m, k, n):
    p = w8.plan(m, k, n)
    assert p.blocks == p.grid[0] * p.grid[1] * p.grid[2]
    if p.blocks < w8.SMS:
        # under a wave only when a split already reaches half a wave, or
        # cannot split further
        assert p.why_short
        assert (p.blocks >= -(-w8.SMS // 2) or p.split == min(p.k_tiles, w8.MAX_SPLIT))
    else:
        assert not p.why_short


@pytest.mark.parametrize("m,k,n", W8_PLAN_SHAPES)
def test_w8_plan_covers_k_exactly_and_fits(m, k, n):
    p = w8.plan(m, k, n)
    assert p.k_tiles * w8.BK >= k > (p.k_tiles - 1) * w8.BK
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == p.k_tiles
    assert all(a < b for a, b in ranges)  # no split is empty
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    assert p.grid[0] * w8.BN >= n and p.grid[1] * p.bt >= m
    assert p.smem_bytes == w8.smem_bytes(p.bt, p.stages) <= SMEM_LIMIT
    longest = max(b - a for a, b in ranges)
    assert 1 <= p.stages <= max(longest, 2)
    if longest > 1:
        assert p.stages >= 2  # a stage is handed back one group late
    if p.split > 1:
        assert p.workspace_floats == p.split * p.tiles * w8.BN * p.bt
        assert p.tickets == p.tiles
    else:
        assert p.workspace_floats == p.tickets == 0


def test_w8_plans_past_a_wave_fit_two_blocks_on_an_sm():
    """Past one wave, a plan sizes its ring so that two blocks share an
    SM's shared memory."""
    for m, k, n in W8_SHAPES:
        p = w8.plan(m, k, n)
        if p.blocks > w8.SMS:
            assert 2 * (p.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("m,k,n", [(4, 40, 8), (4, 48, 20), (0, 48, 8), (4, 0, 8)])
def test_w8_plan_rejects_unsupported_shapes(m, k, n):
    with pytest.raises(ValueError):
        w8.plan(m, k, n)


def test_w8_split_k_scratch_is_keyed_by_device_and_stream(monkeypatch):
    """Two streams never share a split-K workspace or its tile tickets; one
    stream reuses its own, and grows it (zeroed tickets) only for a larger
    plan. A CPU device with an index and stand-in streams take the card's
    place."""
    monkeypatch.setattr(w8, "_scratch", {})
    dev = torch.device("cpu", 0)
    s1, s2 = types.SimpleNamespace(cuda_stream=11), types.SimpleNamespace(cuda_stream=22)
    small, large = w8.plan(64, 1280, 1280), w8.plan(308, 1024, 1280)  # 4 envs' cross K/V
    assert 1 < small.split and 1 < large.split
    assert small.workspace_floats < large.workspace_floats and small.tickets < large.tickets
    a = w8._workspace(dev, small, s1)
    b = w8._workspace(dev, small, s2)
    assert set(w8._scratch) == {(0, 11), (0, 22)}
    assert a[0] != b[0] and a[1] != b[1]
    assert w8._workspace(dev, small, s1) == a  # reused, not grown
    grown = w8._workspace(dev, large, s1)
    ws, tickets = w8._scratch[(0, 11)]
    assert grown != a and ws.numel() == large.workspace_floats
    assert tickets.numel() == large.tickets and not tickets.any()
    assert w8._workspace(dev, small, s2) == b  # the other stream's is untouched
    assert w8._workspace(dev, w8.plan(1024, 640, 640), s1) == (0, 0)  # no split, no scratch


def test_w8_make_plan_rejects_impossible_launches():
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=64, split=9)  # 8 K tiles
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=96)
    with pytest.raises(ValueError):
        w8.make_plan(64, 1024, 1280, bt=64, split=1, stages=1)


@pytest.mark.parametrize("shape", CONV_SHAPES + BATCHED_CONV_SHAPES
                         + [(2, 33, 66, 136, 256), (2, 33, 130, 136, 3)])
def test_conv_plan_fills_the_card_or_says_why(shape):
    b, h, w, c, o = shape
    p = fc.plan(*shape)
    assert p.tiles[0] * p.rows * fc.TILE_W >= h * w
    assert p.tiles[1] * p.bn >= o and p.tiles[2] == b
    assert p.blocks == min(p.n_tiles, fc.SMS)
    if p.n_tiles < fc.SMS:
        assert p.why_short
    else:
        assert not p.why_short
    assert p.chunks * fc.CHUNK >= c > (p.chunks - 1) * fc.CHUNK
    assert p.smem_bytes == fc.smem_bytes(p.bn, p.rows) <= SMEM_LIMIT


def test_conv_plan_tiles():
    """conv_out's 3 channels take the 16-channel, four-row tile; the rest
    128 channels over two rows."""
    for shape in CONV_SHAPES:
        p = fc.plan(*shape)
        assert (p.bn, p.rows) == ((16, 4) if shape[-1] <= 16 else (128, 2))
    assert fc.plan(1, 64, 64, 512, 512).blocks == 128  # 32 pixel tiles x 4


@pytest.mark.parametrize("bn,rows", fc.TILES)
def test_every_conv_tile_fits(bn, rows):
    assert fc.make_plan(1, 64, 64, 512, 512, bn, rows).smem_bytes <= SMEM_LIMIT


def test_conv_make_plan_rejects_a_tile_with_no_kernel():
    with pytest.raises(ValueError):
        fc.make_plan(1, 64, 64, 512, 512, 64, 2)


@pytest.mark.parametrize("shape", [(1, 4, 4, 12, 8), (1, 0, 4, 8, 8), (1, 4, 4, 8, 0)])
def test_conv_plan_rejects_unsupported_shapes(shape):
    with pytest.raises(ValueError):
        fc.plan(*shape)


# B3: (B, Sq, Sk, heads) of the opt-in path, and the card tests' ragged ones
FLASH_PLAN_SHAPES = list(dict.fromkeys(
    [(b, sq, sk, h) for b, sq, sk, _, h in FLASH_SHAPES + BATCHED_FLASH_SHAPES] + [
        (1, sq, sk, 2) for sq in (130, 200) for sk in (1, 77, 129)] + [
        (2, 100, 77, 3), (2, 33, 16, 1), (2, 200, 129, 3), (4, 4096, 4096, 5)]))


@pytest.mark.parametrize("b,sq,sk,h", FLASH_PLAN_SHAPES)
def test_flash_plan_fills_the_card_or_says_why(b, sq, sk, h):
    p = fa.plan(b, sq, sk, h)
    assert p.grid == (-(-sq // p.rows), h, b)
    if p.blocks < fa.SMS:
        assert p.why_short
        # a short grid takes the smaller block, which spreads it further,
        # unless the key loop is long enough for two warpgroups to share it
        assert p.nwg == 1 or p.kv_tiles >= fa.LONG_KEY_LOOP
    else:
        assert not p.why_short


@pytest.mark.parametrize("b,sq,sk,h", FLASH_PLAN_SHAPES)
def test_flash_plan_covers_sq_and_sk(b, sq, sk, h):
    p = fa.plan(b, sq, sk, h)
    assert p.grid[0] * p.rows >= sq > (p.grid[0] - 1) * p.rows
    assert p.kv_tiles * p.bn >= sk > (p.kv_tiles - 1) * p.bn
    # one tile covers the 77 prompt tokens, and no key tile is wider than Sk needs
    if sk <= 80:
        assert p.kv_tiles == 1 and p.bn == (64 if sk <= 64 else 80)
    assert p.stages == min(p.kv_tiles, fa.MAX_STAGES)
    if p.kv_tiles > 1:
        assert p.stages >= 2  # a stage is handed back once the next tile is in


@pytest.mark.parametrize("nwg,bn", fa.TILES)
@pytest.mark.parametrize("b,sq,sk,h", [(1, 4096, 4096, 5), (1, 64, 77, 20), (2, 200, 129, 3)])
def test_flash_plan_fits_shared_memory_and_registers(nwg, bn, b, sq, sk, h):
    for stages in range(2 if -(-sk // bn) > 1 else 1, fa.MAX_STAGES + 1):
        p = fa.make_plan(b, sq, sk, h, nwg, bn, stages)
        assert p.smem_bytes == fa.smem_bytes(nwg, bn, stages) <= SMEM_LIMIT
        # the blocks the launch bounds promise an SM fit its shared memory and
        # its register file (at the registers ptxas may then use)
        assert p.blocks_per_sm * (p.smem_bytes + 1024) <= fa.SMEM_SM
        assert p.blocks_per_sm * p.threads * p.max_registers <= fa.REGISTERS_SM
        # a 384-thread block starts at 168, what setmaxnreg's 24 + 2 x 240 needs;
        # a 512-thread one at 128, for 24 + 3 x 160
        if nwg == 2:
            assert p.max_registers == 168 and 24 * 128 + 240 * 256 <= 168 * p.threads
        if nwg == 3:
            assert p.max_registers == 128 and 24 * 128 + 160 * 384 <= 128 * p.threads


def test_flash_plan_picks_one_tile_for_the_prompt_and_two_warpgroups_for_long_key_loops():
    p = fa.plan(1, 4096, 77, 5)
    assert (p.nwg, p.bn, p.kv_tiles) == (1, 80, 1)
    # 22 tiles of 192 rows x 5 heads = 110 blocks, one wave (two
    # warpgroups: 160 blocks of 128 rows)
    p = fa.plan(1, 4096, 4096, 5)
    assert (p.nwg, p.bn, p.blocks) == (3, 128, 110)
    p = fa.plan(1, 1024, 1024, 10)  # 8 key tiles: 80 blocks of two warpgroups
    assert (p.nwg, p.bn, p.blocks) == (2, 128, 80) and "K/V tiles" in p.why_short
    p = fa.plan(1, 256, 256, 20)  # 2 key tiles: 80 blocks of one warpgroup
    assert (p.nwg, p.bn, p.blocks) == (1, 128, 80)


@pytest.mark.parametrize("b,sq,sk,h", [(0, 64, 64, 1), (1, 0, 64, 1), (1, 64, 0, 1), (1, 64, 64, 0)])
def test_flash_plan_rejects_empty_shapes(b, sq, sk, h):
    with pytest.raises(ValueError):
        fa.plan(b, sq, sk, h)


def test_flash_make_plan_rejects_impossible_launches():
    with pytest.raises(ValueError):
        fa.make_plan(1, 256, 256, 2, nwg=3, bn=64)  # no such kernel
    with pytest.raises(ValueError):
        fa.make_plan(1, 256, 256, 2, nwg=1, bn=96)
    with pytest.raises(ValueError):
        fa.make_plan(1, 256, 256, 2, nwg=1, bn=64, stages=1)  # 4 tiles need 2 stages
    with pytest.raises(ValueError):
        fa.make_plan(1, 256, 256, 2, nwg=1, bn=64, stages=5)


# B2b: (B, Sq, Sk, heads) of the train step, and the card tests' Sq != Sk and
# odd multiples of 64
BWD_PLAN_SHAPES = [(b, s, s, h) for b, s, _, h in TRAIN_LEVELS] + [
    (2, 1024, 4096, 5), (2, 4096, 1024, 5), (2, 192, 320, 5), (1, 320, 64, 2), (3, 64, 192, 1)]


@pytest.mark.parametrize("b,sq,sk,h", BWD_PLAN_SHAPES)
def test_backward_plan_fills_the_card_or_says_why(b, sq, sk, h):
    p = pa.backward_plan(b, sq, sk, h)
    short = [g for g in (p.dq_grid, p.dkdv_grid) if g[0] * g[1] * g[2] < pa.SMS]
    assert bool(short) == bool(p.why_short)
    if (b, sq, sk, h) in [(b, s, s, h) for b, s, _, h in TRAIN_LEVELS]:
        assert not short  # the train step's levels fill the card


@pytest.mark.parametrize("b,sq,sk,h", BWD_PLAN_SHAPES)
def test_backward_plan_covers_sq_and_sk(b, sq, sk, h):
    p = pa.backward_plan(b, sq, sk, h)
    for grid, s in ((p.dq_grid, sq), (p.dkdv_grid, sk)):
        assert grid[1:] == (h, b)
        assert grid[0] * pa.BWD_BLOCK_ROWS >= s > (grid[0] - 1) * pa.BWD_BLOCK_ROWS
        # an odd multiple of 64 leaves the last block one 64-row warpgroup
        assert (grid[0] * pa.BWD_BLOCK_ROWS - s) in (0, 64)


def test_backward_plan_fits_shared_memory_and_registers():
    p = pa.backward_plan(4, 4096, 4096, 5)
    assert max(p.dq_smem_bytes, p.dkdv_smem_bytes) <= SMEM_LIMIT
    # the ring: 4 stages of two 64 x 64 bf16 tiles; dk/dv adds 2 x 64 f32 a stage
    assert p.dkdv_smem_bytes - p.dq_smem_bytes == pa.BWD_STAGES * 2 * 64 * 4
    # one 384-thread block an SM at 168 registers; setmaxnreg's 24 + 2 x 240
    # stays within what the block started with
    assert p.max_registers == 168
    assert 24 * 128 + 240 * 256 <= p.max_registers * pa.BWD_THREADS <= pa.REGISTERS_SM


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 65, 64, 1, 64), (1, 64, 100, 1, 64),
                                         (1, 64, 64, 1, 0), (1, 0, 64, 1, 64),
                                         (0, 64, 64, 1, 64), (1, 64, 64, 0, 64)])
def test_backward_plan_rejects_what_the_kernels_cannot_take(b, sq, sk, h, d):
    with pytest.raises(ValueError):
        pa.backward_plan(b, sq, sk, h, d)


# B1/B2a: (B, Sq, Sk, heads) of the control step (batch 1) and the train step
# (batch 4), and the card tests': the levels at batch 2, ragged last blocks
# (Sq an odd multiple of 64) and Sq != Sk
FORWARD_PLAN_SHAPES = sorted(
    {(b, s, s, h) for b, s, _, h in SD_LEVELS + TRAIN_LEVELS}
    | {(2, s, s, h) for _, s, _, h in SD_LEVELS}
    | {(2, sq, sk, 5) for sq in (192, 320) for sk in (64, 512)}
    | {(2, 256, 512, 2), (1, 64, 64, 1), (3, 4096, 64, 1)})
SRC = Path(pa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("b,sq,sk,h", FORWARD_PLAN_SHAPES)
def test_forward_plan_fills_the_card_or_says_why(b, sq, sk, h):
    p = pa.forward_plan(b, sq, sk, h)
    assert p.grid == (-(-sq // p.rows), h, b)
    if p.blocks < pa.SMS:
        assert p.why_short
        # a short grid takes the smallest block, which spreads it furthest,
        # unless the key loop is long enough for warpgroups to share it
        assert p.nwg == 1 or p.kv_tiles >= fa.LONG_KEY_LOOP
    else:
        assert not p.why_short


@pytest.mark.parametrize("b,sq,sk,h", FORWARD_PLAN_SHAPES)
def test_forward_plan_covers_sq_and_sk(b, sq, sk, h):
    p = pa.forward_plan(b, sq, sk, h)
    assert (p.nwg, p.bn) in pa.FORWARD_TILES
    assert p.grid[0] * p.rows >= sq > (p.grid[0] - 1) * p.rows
    # Sk is a multiple of 64: the key tiles cover it exactly unless one
    # 128-key tile is half masked
    assert p.kv_tiles * p.bn >= sk > (p.kv_tiles - 1) * p.bn
    assert p.bn == 64 or sk > 64
    assert p.stages == min(p.kv_tiles, fa.MAX_STAGES)
    if p.kv_tiles > 1:
        assert p.stages >= 2  # a stage is handed back once the next tile is in


def test_forward_tiles_and_smem_mirror_the_sources():
    """The (nwg, bn) instantiations each source launches are its plan's
    tiles, and the plans' shared memory is ``fwd_smem_bytes``, read from
    the CUDA sources."""
    for src, tiles, wide, widest in (
            ("packed_attention.cu", pa.FORWARD_TILES, pa.WIDE_FORWARD_TILES,
             pa.WIDEST_FORWARD_TILES),
            ("flash_attention.cu", fa.TILES, fa.WIDE_TILES, fa.WIDEST_TILES)):
        # launch_fwd<atoms, nwg, bn, lse>: before the one-atom branch, every
        # head's; in it, "1"; in the next, "DA" for two and three atoms; the
        # last (four atoms) launches nothing more
        common, branches = (SRC / src).read_text().split("if constexpr (DA == 1)")
        one_atom, rest = branches.split("} else if constexpr (DA < 4) {")
        wider, widest_branch = rest.split("} else {", 1)

        def found(text, atoms):
            return {(int(n), int(b)) for n, b in
                    re.findall(rf"launch_fwd<{atoms}, (\d), (\d+), \w+>", text)}

        assert sorted(found(common, "DA") | found(one_atom, "1")) == sorted(tiles), src
        assert sorted(found(common, "DA") | found(wider, "DA")) == sorted(wide), src
        assert not found(widest_branch.split("}")[0], "DA"), src
        assert sorted(found(common, "DA")) == sorted(widest), src
    body = re.search(r"int fwd_smem_bytes\(int nwg, int bn, int stages, int atoms\) \{"
                     r"\s*return ([^;]+);",
                     (SRC / "attention_fwd_hopper.cuh").read_text()).group(1)
    for atoms, tiles in ((1, pa.FORWARD_TILES + fa.TILES), (2, fa.WIDE_TILES), (3, fa.WIDE_TILES),
                         (4, fa.WIDEST_TILES)):
        for nwg, bn in tiles:
            for stages in range(1, fa.MAX_STAGES + 1):
                want = eval(f"({body})", {"nwg": nwg, "bn": bn, "stages": stages,
                                          "kRowBytes": 128, "atoms": atoms})
                assert fa.smem_bytes(nwg, bn, stages, atoms) == want


def test_wide_forward_plans_mirror_the_sources():
    """The wide forwards' constants and shared-memory counts, read from the
    CUDA sources, are the plans': the paired kernel's atoms a warpgroup,
    item bytes, key splits and ``pair_fwd_smem_bytes`` at every ring depth;
    the clustered f32 kernel's atoms a chunk, chunks a cluster, exchange
    bytes and ``cluster_smem_bytes_f32`` at every chunk count."""
    fwd = (SRC / "attention_fwd_hopper.cuh").read_text()
    f32 = (SRC / "attention_f32_hopper.cuh").read_text()
    common = (SRC / "attention_hopper.cuh").read_text()
    env = {"kWideT": 32, "kSlabBytes": fa.F32_SLAB_BYTES, "kAtomTile": fa.ATOM_TILE_BYTES}

    def const(src, name):
        env[name] = eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1), dict(env))
        return env[name]

    assert const(fwd, "kPairAtoms") == fa.PAIR_ATOMS
    assert const(fwd, "kPairItem") == 2 * fa.PAIR_ATOMS * fa.ATOM_TILE_BYTES
    assert const(fwd, "kMaxSplits") == fa.MAX_SPLITS
    assert const(common, "kMaxWideStages") == fa.WIDE_STAGES
    assert const(f32, "kClusterAtomsF32") == fa.F32_CLUSTER_ATOMS
    assert const(f32, "kClusterChunksF32") == fa.F32_CLUSTER_CHUNKS
    assert const(f32, "kXBytesF32") == fa.F32_EXCHANGE_BYTES
    for name in ("kClusterQ", "kClusterTile", "kClusterSlot"):
        const(f32, name)
    assert env["kClusterSlot"] == fa.WIDE_SLOT_BYTES
    body = re.search(r"int pair_fwd_smem_bytes\(int stages\) \{\s*return ([^;]+);", fwd).group(1)
    f32_body = re.search(r"int cluster_smem_bytes_f32\(int chunks, int stages\) \{"
                         r"\s*return ([^;]+);", f32).group(1)
    for stages in range(2, fa.WIDE_STAGES + 1):
        assert fa.pair_smem_bytes(stages) == eval(f"({body})", dict(env, stages=stages))
        for chunks in range(5, fa.F32_CLUSTER_CHUNKS + 1):
            want = eval(f"({f32_body})", dict(env, chunks=chunks, stages=stages))
            assert fa.f32_cluster_smem_bytes(chunks, stages) == want


@pytest.mark.parametrize("d", WIDE_SWEEP_DIMS)
def test_wide_forward_plans_fit_the_card_at_every_sweep_d(d):
    """At every d of the card's sweep the wide forwards' plans (bf16 and
    f32, the sweep's and the path's shapes) fit 227 KB, their clusters the
    key splits (bf16) or the chunks (clustered f32) and no more than a
    portable cluster, their rings two slots at least and, where the keys are
    split, room for the merge."""
    h = _sweep_heads(d)
    bf16 = [pa.forward_plan(1, 4096, 4096, 1, d), pa.forward_plan(4, 1024, 1024, h, d),
            fa.plan(1, 1000, 1000, h, d), fa.plan(1, 1000, 77, h, d),
            pa.forward_plan(1, 1024, 1024, 1, d), pa.forward_plan(1, 256, 256, 2, d)]
    f32 = [fa.f32_plan(1, 4096, 4096, 1, d), fa.f32_plan(4, 1024, 1024, h, d),
           fa.f32_plan(1, 1000, 77, h, d, key80=True)]
    for p in bf16 + f32:
        assert p.smem_bytes <= SMEM_LIMIT and 2 <= p.stages <= fa.WIDE_STAGES
        assert p.cluster <= 8 and p.grid[0] % p.cluster == 0
    for p in bf16:
        assert p.cluster == p.splits <= fa.MAX_SPLITS
        assert p.splits == 1 or p.nwg == 1 or fa.pair_merge_fits(p.stages)
    for p in f32:
        assert p.splits == 1
        assert p.cluster == (p.chunks if fa.f32_clustered(p.atoms) else 1)


def test_wide_forward_rows_find_their_ptxas_report():
    """chip_smoke's rows name each wide forward by the key ``ptxas_report``
    gives its kernel in an ``nvcc -Xptxas -v`` log: the paired kernel at
    d = 320, the streaming one at 640 (chunks of four atoms), both with
    their keys split, the clustered f32 one at 640 and the streaming f32 one
    at 320."""
    import chip_smoke

    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Used {regs} registers, 0 bytes spill stores, 0 bytes spill loads"
        for name, regs in (
            ("_ZN11attn_hopper12_GLOBAL__N_125attention_fwd_pair_kernelILb1ELb1EEEvN", 232),
            ("_ZN11attn_hopper12_GLOBAL__N_125attention_fwd_wide_kernelILi4ELb0ELb1EEEvN", 202),
            ("_ZN8attn_f3212_GLOBAL__N_132attention_f32_fwd_cluster_kernelILb0EEEvN", 250),
            ("_ZN8attn_f3212_GLOBAL__N_129attention_f32_fwd_wide_kernelILi3ELb0EEEvN", 255)))
    report = chip_smoke.ptxas_report(log)
    assert report["pair_1x1"]["registers"] == 232 and report["wide_4x0x1"]["registers"] == 202
    assert report["f32_cluster_0"]["registers"] == 250
    assert report["f32_wide_3x0"] == {"registers": 255, "spill_bytes": 0}
    assert chip_smoke._kernel_key(pa.forward_plan(1, 4096, 4096, 1, 320), True) == "pair_1x1"
    assert chip_smoke._kernel_key(fa.plan(1, 1024, 1024, 1, 640), False) == "wide_4x0x1"
    assert chip_smoke._f32_kernel_key(fa.f32_plan(1, 1024, 1024, 1, 640), False) in report
    assert chip_smoke._f32_kernel_key(fa.f32_plan(1, 4096, 4096, 1, 320), False) in report


def test_wide_backward_plans_mirror_the_source():
    """B2b's wide kernels: the constants of ``packed_attention_bwd.cu`` the
    plan mirrors (hand-over buffers, ring depths and slots, the split
    limits, the f32 ring) are the plan's, and chip_smoke finds the three
    kernels' ptxas rows (dq, dV, dK; bf16 with its OA and residency, f32 with
    its OA) under the keys it looks them up by."""
    import chip_smoke

    src = (SRC / "packed_attention_bwd.cu").read_text()

    def const(name):
        return int(eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1),
                        {"kWideT": 32}))

    assert const("kWideXBuf") == pa.WIDE_BWD_XBUF
    assert const("kWideMaxOStages") == pa.WIDE_BWD_MAX_O_STAGES
    assert const("kBlockSmem") == fa.SMEM_BLOCK
    assert const("kWideBwdSms") == pa.SMS and const("kWideBwdMaxSplits") == fa.MAX_SPLITS
    assert const("kWideBwdItems") == pa.WIDE_BWD_F32_ITEMS
    assert const("kWideXBufF32") == 128 * 16 * 4
    assert const("kWideProducerRegs") == const("kWideProducerRegsF32") == 40
    assert const("kWideBwdThreads") == 384
    assert const("kWideEMax") == pa.WIDE_BWD_E_MAX
    for mode in pa.WIDE_BWD_MODES:
        for atoms in (5, 6, 7, 10, 16, 64):
            smem, o_stages, e_stages = pa.wide_backward_rings(mode, atoms)
            # a tile's O atoms and one more; two early slots at least
            o_atoms = min(atoms, 2 * pa.wide_backward_out_atoms(atoms))
            assert smem <= fa.SMEM_BLOCK and o_stages > o_atoms and 2 <= e_stages <= 16
    names = {  # mangled as nvcc names them (packed_attention_bwd.cu's kernels)
        "wide_0x3x1": "_ZN12_GLOBAL__N_115bwd_wide_kernelILi0ELi3ELb1EEEv14CUtensorMap_st",
        "wide_2x5x0": "_ZN12_GLOBAL__N_115bwd_wide_kernelILi2ELi5ELb0EEEv14CUtensorMap_st",
        "f32_wide_1x3": "_ZN8attn_f3212_GLOBAL__N_129attention_f32_bwd_wide_kernelILi1ELi3EEEv14",
    }
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Used 168 registers, 0 bytes spill stores, 0 bytes spill loads"
        for name in names.values())
    report = chip_smoke.ptxas_report(log)
    assert set(report) == set(names)
    assert chip_smoke._wide_bwd_keys(5, f32=False)["dq"] == "wide_0x3x1"
    assert chip_smoke._wide_bwd_keys(10, f32=False)["dv"] == "wide_2x5x0"
    assert chip_smoke._wide_bwd_keys(10, f32=True)["dk"] == "f32_wide_1x3"


# (B, Sq, Sk, heads, d) -> key splits: the wide-head path's levels and B3's
@pytest.mark.parametrize("b,sq,sk,h,d,splits", [
    (1, 4096, 4096, 1, 320, 2),   # 64 blocks of the paired kernel: 128
    (4, 4096, 4096, 1, 320, 1),   # 256 blocks
    (1, 1024, 1024, 1, 320, 4),   # 16 blocks: four ranges of four tiles
    (1, 4096, 77, 1, 320, 1),     # the prompt's two key tiles (the streaming kernel)
    (1, 1024, 1024, 1, 640, 2),   # 48 blocks of the streaming kernel (3 chunks): 96
    (1, 256, 256, 2, 640, 2),     # 24: 48, ranges of two tiles
    (4, 1024, 1024, 1, 640, 1),   # 192
    (1, 64, 64, 2, 640, 1),       # one key tile
    (1, 1024, 77, 1, 640, 1),     # two key tiles
])
def test_wide_key_splits_only_where_the_grid_is_short(b, sq, sk, h, d, splits):
    p = pa.forward_plan(b, sq, sk, h, d)
    assert p.nwg == (2 if d <= 384 and sk > 128 else 1)  # the paired kernel, else streaming
    assert p.splits == splits and fa.plan(b, sq, sk, h, d).splits == splits
    assert bool(p.why_short) == (p.blocks // splits < fa.SMS)
    assert p.blocks <= fa.SMS or splits == 1
    assert ("keys split" in p.why_short) == (splits > 1)
    assert fa.f32_plan(b, sq, sk, h, d).splits == 1


@pytest.mark.parametrize("nwg,bn", pa.FORWARD_TILES)
@pytest.mark.parametrize("b,sq,sk,h", [(4, 4096, 4096, 5), (1, 256, 256, 20), (2, 192, 64, 5)])
def test_forward_plan_fits_shared_memory_and_registers(nwg, bn, b, sq, sk, h):
    tiles = -(-sk // bn)
    for stages in range(2 if tiles > 1 else 1, fa.MAX_STAGES + 1):
        p = pa.make_forward_plan(b, sq, sk, h, nwg, bn, stages)
        assert p.smem_bytes == fa.smem_bytes(nwg, bn, stages) <= SMEM_LIMIT
        assert p.blocks_per_sm * (p.smem_bytes + 1024) <= fa.SMEM_SM
        assert p.blocks_per_sm * p.threads * p.max_registers <= fa.REGISTERS_SM
        # setmaxnreg: the producer warpgroup drops to 24 and the consumers
        # rise to 240 (two) or 160 (three) within what the block started with
        if nwg == 2:
            assert p.max_registers == 168 and 24 * 128 + 240 * 256 <= 168 * p.threads
        if nwg == 3:
            assert p.max_registers == 128 and 24 * 128 + 160 * 384 <= 128 * p.threads


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 64, 0, 1, 64), (1, 64, 64, 1, -8),
                                         (1, 64, 64, 1, 0), (1, 0, 64, 1, 64),
                                         (0, 64, 64, 1, 64), (1, 64, 64, 0, 64)])
def test_forward_plan_rejects_what_the_kernel_cannot_take(b, sq, sk, h, d):
    with pytest.raises(ValueError):
        pa.forward_plan(b, sq, sk, h, d)


def test_make_forward_plan_rejects_impossible_launches():
    with pytest.raises(ValueError):
        pa.make_forward_plan(1, 256, 256, 2, nwg=1, bn=80)  # B3's prompt tile: not built here
    with pytest.raises(ValueError):
        pa.make_forward_plan(1, 256, 256, 2, nwg=4, bn=128)
    with pytest.raises(ValueError):
        pa.make_forward_plan(1, 256, 256, 2, nwg=1, bn=64, stages=1)  # 4 tiles need 2 stages
    with pytest.raises(ValueError):
        pa.make_forward_plan(1, 256, 256, 2, nwg=1, bn=64, stages=5)
    with pytest.raises(ValueError, match="no kernel"):  # B1 takes Sq = 200, not this tile
        pa.make_forward_plan(1, 200, 256, 2, nwg=3, bn=64)


@pytest.mark.parametrize("b,sq,sk,h", FORWARD_PLAN_SHAPES)
def test_b1_and_b2a_launch_one_plan(monkeypatch, b, sq, sk, h):
    """B1 and B2a pass ``forward_plan``'s (nwg, bn, stages) to their C entry
    points, the same at every shape: the key tile sets the order of the
    online-softmax updates, and B2a's output must be B1's bit for bit. (The
    C library is replaced by a recorder; nothing is launched.)"""
    calls = {}

    def record(name):
        def fn(*args):
            calls[name] = args
            return 0
        return fn

    fake = types.SimpleNamespace(packed_attention_fwd=record("B1"),
                                 packed_attention_fwd_lse=record("B2a"),
                                 packed_attention_error_string=lambda rc: b"")
    monkeypatch.setattr(pa, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    for fn in (pa.packed_flash_attention, pa.packed_attention_forward_lse):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_shape", type(fn.launches_by_shape)())
    c = 64 * h
    q = torch.zeros(b, sq, c, dtype=torch.bfloat16)
    k = torch.zeros(b, sk, c, dtype=torch.bfloat16)
    out = pa._launch_forward(q, k, k, h, with_lse=False)
    o, lse = pa._launch_forward(q, k, k, h, with_lse=True)
    assert out.shape == o.shape == q.shape and lse.shape == (b, sq, h)
    p = pa.forward_plan(b, sq, sk, h)
    assert calls["B1"][4:] == (b, sq, sk, h, 64, 64, p.nwg, p.bn, p.stages, p.splits, 7)
    assert calls["B2a"][5:] == calls["B1"][4:]
    assert pa.packed_flash_attention.launches == pa.packed_attention_forward_lse.launches == 1
