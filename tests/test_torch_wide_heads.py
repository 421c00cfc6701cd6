"""Heads wider than 256 columns, and B1 at every length the TPU kernel takes.

The JAX kernels take any head dim; the port's CUDA kernels read a head past
four 64-column atoms through the wide kernels (B1/B2a/B3 at five or six
atoms with two warpgroups sharing S, above in chunks of O; B2b's dQ, dK
and dV for the whole head a block up to ten atoms, two warpgroups sharing S
and dP, past that in chunks of eight).
On the CPU, at small sizes:

* the port's plain versions of B1, B2a and B2b at d = 320 and 640 against
  JAX's ``packed_flash_attention``, its ``_forward_with_lse`` and ``jax.grad``
  through its custom VJP, in interpret mode; B3's plain version at d = 320
  against JAX's ``flash_attention``;
* B1 at 128x77 and 77x77 (lengths off a multiple of 64) against JAX's
  kernel;
* a UNet at (320, 640) channels in one head each (d = 320 and 640), on the
  same weights (moved by ``state_dict_from_jax``), against JAX's noise
  prediction;
* the key split and merge of the wide forwards, in plain PyTorch, against
  JAX's kernel, and the wide backward's split tile loop and merge against
  JAX's custom VJP;
* the launch plans at d = 264 to 1024: kernel choice, chunk counts, key
  splits, shared memory within what a block may take, no raise.

The CUDA kernels are held to these plain versions on the card in
test_torch_cuda_kernels.py and chip_smoke.py phase 18.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.core.init_utils import fast_init
from genima_tpu.kernels.flash_attention import flash_attention as jax_flash
from genima_tpu.kernels.packed_attention import _forward_with_lse
from genima_tpu.kernels.packed_attention import packed_flash_attention as jax_packed
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig

from genima_torch.eval.main_path import VARIANTS, wide_head_pipeline
from genima_torch.kernels import flash_attention as fa
from genima_torch.kernels import packed_attention as pa
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.weights.from_jax import state_dict_from_jax

WIDE_DIMS = [320, 640]
FWD_ATOL = 2e-4  # o and L in f32: sums over 320-640 columns in another order
GRAD_ATOL = 2e-4  # as test_torch_packed_attention_bwd.py holds the custom VJP's gradients
UNET_ATOL = 1e-4  # as test_torch_layers_models.py holds a UNet's noise prediction
SMEM_LIMIT = 232448  # what the H100 gives one block: 227 KB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packed(sq, sk, c, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, s, c).astype(np.float32) for s in (sq, sk, sk)]


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("h", [1, 2])
def test_b1_plain_version_matches_pallas_kernel(d, h):
    q, k, v = _packed(128, 128, h * d, seed=d + h)
    want = jax_packed(*map(jnp.asarray, (q, k, v)), h)
    got = pa.packed_attention_reference(*map(torch.from_numpy, (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_b2a_plain_version_matches_pallas_kernel(d):
    q, k, v = _packed(128, 128, 2 * d, seed=d + 3)
    want_o, want_l = _forward_with_lse(*map(jnp.asarray, (q, k, v)), 2, 128, True)
    got_o, got_l = pa.packed_attention_forward_lse(*map(torch.from_numpy, (q, k, v)), 2)
    assert got_l.shape == (1, 128, 2)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=FWD_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=FWD_ATOL)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_b2b_autograd_matches_jax_custom_vjp(d):
    """``PackedFlashAttention`` (B2a forward, B2b backward, no fallback)
    against ``jax.grad`` through the JAX custom VJP (``_bwd_kernel``)."""
    q, k, v = _packed(128, 128, d, seed=d + 4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fallbacks = pa.PackedFlashAttention.fallbacks
    out = pa.packed_flash_attention(*leaves, 1)
    assert type(out.grad_fn).__name__ == "PackedFlashAttentionBackward"
    (out ** 2).sum().backward()
    assert pa.PackedFlashAttention.fallbacks == fallbacks

    def loss(q, k, v):
        return (jax_packed(q, k, v, 1) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, x, y in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_key_split_merge_matches_pallas_kernel(splits):
    """The clustered wide kernel's key split and merge in plain PyTorch
    (``pa.packed_attention_split_reference``) at d = 320, 2 heads, Sq 128
    and Sk 320 (five 64-key tiles: ranges of one to three tiles) against
    JAX's ``_forward_with_lse`` in interpret mode: o and L at ``FWD_ATOL``
    (f32; the same sums regrouped by range)."""
    q, k, v = _packed(128, 320, 640, seed=splits)
    want_o, want_l = _forward_with_lse(*map(jnp.asarray, (q, k, v)), 2, 128, True)
    got_o, got_l = pa.packed_attention_split_reference(*map(torch.from_numpy, (q, k, v)), 2,
                                                       splits)
    assert got_o.shape == (1, 128, 640) and got_l.shape == (1, 128, 2)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=FWD_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=FWD_ATOL)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_backward_split_merge_matches_jax_custom_vjp(d):
    """The wide backward's split tile loop and its merge in split order in
    plain PyTorch (``pa.packed_attention_backward_split_reference``) at
    Sq 128, Sk 320 (dq over five key tiles in one to four ranges, dk and dv
    over two query tiles in one or two) against ``jax.grad`` through JAX's
    custom VJP (``_bwd_kernel``, interpret mode), at ``GRAD_ATOL``."""
    q, k, v = _packed(128, 320, d, seed=d + 5)

    def loss(q, k, v):
        return (jax_packed(q, k, v, 1) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = pa.packed_attention_lse_reference(tq, tk, tv, 1)
    for splits in (1, 2, 4):
        got = pa.packed_attention_backward_split_reference(tq, tk, tv, o, lse, 2 * o, 1, splits)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL,
                                       err_msg=f"{name}, {splits} splits")


def test_wide_backward_splits_fill_short_grids():
    """B2b's wide launches split their tile loop only where the grid is under
    one wave, two tiles a range at least: none at the ``sd_wide`` level of
    4 x 4096 (256 blocks), two at 4 x 1024 in one head of 640 (64 blocks;
    f32's two chunks fill the card), two at 4 x 256 in two heads (32 blocks
    over four tiles; f32 two), the grid x times the splits and within one
    wave."""
    for (b, s, c, h), bf16, f32 in (((4, 4096, 320, 1), 1, 1), ((4, 1024, 640, 1), 2, 1),
                                    ((4, 256, 1280, 2), 2, 2)):
        for dtype, want in ((torch.bfloat16, bf16), (torch.float32, f32)):
            bp = pa.backward_plan(b, s, s, h, c // h, dtype=dtype)
            assert bp.splits == bp.dkdv_splits == want
            blocks = s // 64 * bp.chunks
            assert bp.dq_grid == (blocks * want, h, b)
            assert want == 1 or blocks * want * h * b <= pa.SMS
    assert pa.wide_backward_splits(6, 6) == 3 and pa.wide_backward_splits(6, 5) == 2
    assert pa.wide_backward_splits(200, 64) == 1


@pytest.mark.parametrize("sq,sk", [(128, 128), (100, 77)])
def test_b3_plain_version_matches_pallas_kernel(sq, sk):
    """Self-attention, and cross-attention over the 77 prompt tokens, at
    d = 320."""
    rng = np.random.RandomState(sk)
    q, k, v = (rng.randn(1, s, 1, 320).astype(np.float32) for s in (sq, sk, sk))
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=32)
    got = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("sq,sk", [(128, 77), (77, 77)])
@pytest.mark.parametrize("d,h", [(64, 5), (320, 1)])
def test_b1_at_ragged_lengths_matches_pallas_kernel(sq, sk, d, h):
    """JAX's ``_forward`` takes any Sq <= 128 and any Sk (K/V resident); so
    does the port's B1, whose wrapper no longer asks for multiples of 64."""
    q, k, v = _packed(sq, sk, h * d, seed=sq + sk + d)
    want = jax_packed(*map(jnp.asarray, (q, k, v)), h)
    got = pa.packed_flash_attention(*map(torch.from_numpy, (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    # the card's input checks take the lengths for B1 and B2a, not for B2b
    tq, tk = torch.zeros(1, sq, h * d, dtype=torch.bfloat16), torch.zeros(1, sk, h * d,
                                                                           dtype=torch.bfloat16)
    pa._check_cuda_inputs(tq, tk, tk, h, whole_tiles=False)
    with pytest.raises(ValueError, match="multiple of 64"):
        pa._check_cuda_inputs(tq, tk, tk, h)
    assert not pa.kernel_tiles(tq, tk)


# a UNet at sd-turbo's first two widths in one head each: d = 320 at level 0
# (256 tokens at 16x16 latents, the packed route in both packages) and 640
# in the mid block (64 tokens: the library attention in both)
WIDE_UNET = dict(block_out_channels=(320, 640), num_heads=(1, 1), layers_per_block=1)


def test_wide_head_unet_noise_prediction_matches_jax():
    cfg = JaxUNetConfig.tiny(sample_size=8, **WIDE_UNET)
    jm = JaxUNet(cfg, backend="fused")
    p = fast_init(jm, jax.random.key(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                  jnp.zeros((1, 4, cfg.cross_attention_dim)), seed=20)["params"]
    rng = np.random.RandomState(0)
    sample = rng.randn(1, 16, 16, 4).astype(np.float32)
    t = np.array([500.0], np.float32)
    ctx = rng.randn(1, 4, cfg.cross_attention_dim).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(sample), jnp.asarray(t),
                               jnp.asarray(ctx)))
    tm = UNet2DConditionModel(UNetConfig.tiny(**WIDE_UNET))
    tree = jax.tree_util.tree_map(np.asarray, p)
    tm.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in
                        state_dict_from_jax(tree, "diffusers_unet").items()}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(sample.transpose(0, 3, 1, 2))),
                 torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=UNET_ATOL)


def test_wide_head_pipeline_gives_heads_of_320_and_640():
    assert VARIANTS["sd_wide"].PIPELINE is wide_head_pipeline
    cfg = UNetConfig.sd21(num_heads=(1, 1, 2, 2))
    dims = [c // h for c, h in zip(cfg.block_out_channels, cfg.num_heads)]
    assert dims == [320, 640, 640, 640]
    assert [fa.head_atoms(d) for d in dims[:2]] == [5, 10]


@pytest.mark.parametrize("d", [264, 320, 384, 512, 640, 1024])
def test_wide_plans_chunk_the_head_and_fit_the_card(d):
    """B1/B2a's, B3's and B2b's plans, bf16 and f32, at heads past four
    atoms, every d of the card's sweep: five or six atoms the paired kernel
    (two warpgroups of three atoms of O, the whole head a block) over more
    than two key tiles, else the streaming kernel (O in chunks of three or
    four atoms, one a block); the
    keys split only where the grid is short, a cluster of the splits, the
    ring then holding the merge; f32 the clustered kernel (chunks of two
    atoms, a CTA each) from nine atoms on; shared memory within what a block
    may take; B2b's dQ, dK and dV for the whole head a block up to ten
    atoms (f32: eight), two consumer warpgroups of three to five atoms each,
    the rows resident up to six atoms (bf16), chunks of eight past."""
    atoms = fa.head_atoms(d)
    chunks, per = fa.wide_chunking(atoms)
    assert chunks == -(-atoms // 4) and per in (3, 4) and (chunks - 1) * per < atoms <= chunks * per
    assert fa.paired(atoms) == (d <= 384) and fa.f32_clustered(atoms) == (d > 512)
    for p in (pa.forward_plan(1, 4096, 4096, 1, d), fa.plan(1, 1000, 77, 2, d),
              pa.forward_plan(1, 96, 4096, 1, d), pa.forward_plan(1, 1024, 1024, 1, d),
              fa.plan(1, 64, 64, 2, d)):
        assert (p.bn, p.atoms, p.rows) == (64, atoms, 64)
        # the paired kernel where it fits and the key loop passes two tiles
        assert (p.nwg == 2) == (fa.paired(atoms) and p.kv_tiles > fa.PAIR_MIN_TILES)
        if p.nwg == 2:
            assert (p.nwg, p.chunks, p.threads, p.stages) == (2, 1, 384, fa.pair_stages())
            assert p.smem_bytes == fa.pair_smem_bytes(p.stages) <= SMEM_LIMIT
            assert p.splits == 1 or fa.pair_merge_fits(p.stages)
        else:
            assert (p.nwg, p.chunks, p.threads, p.stages) == (1, chunks, 160, fa.WIDE_STAGES)
            assert p.smem_bytes == fa.smem_bytes(1, 64, p.stages, atoms) <= SMEM_LIMIT
            assert p.max_registers == 255
        assert p.cluster == p.splits and 1 <= p.splits <= fa.MAX_SPLITS
        assert p.splits == 1 or (p.why_short and p.splits * fa.MIN_SPLIT_TILES <= p.kv_tiles)
        assert p.grid[0] % p.cluster == 0
    f = fa.f32_plan(1, 4096, 4096, 1, d)
    f_chunks, f_per = fa.f32_wide_chunking(atoms)
    assert (f.nwg, f.bn, f.chunks, f.threads, f.splits) == (1, 32, f_chunks, 256, 1)
    assert f.grid == (64 * f_chunks, 1, 1) and f.smem_bytes <= SMEM_LIMIT
    if fa.f32_clustered(atoms):
        assert (f.cluster, f_per, f.stages) == (f_chunks, 2, fa.f32_cluster_stages(f_chunks))
        assert f.smem_bytes == fa.f32_cluster_smem_bytes(f_chunks, f.stages)
    else:
        assert (f.cluster, f_chunks, f.stages) == (1, chunks, fa.WIDE_STAGES)
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        bp = pa.backward_plan(4, 1024, 1024, 8, d, dtype=dtype)
        b_chunks, oa = pa.wide_backward_chunks(atoms, f32), pa.wide_backward_out_atoms(atoms, f32)
        # the whole head a block up to ten atoms (f32: eight): two warpgroups of oa atoms
        assert bp.chunks == b_chunks == (1 if d <= (512 if f32 else 640) else -(-atoms // 8))
        assert oa == (3 if d <= 384 or (f32 and d == 640) else 4 if d in (512, 1024) else 5)
        assert (b_chunks - 1) * 2 * oa < atoms <= b_chunks * 2 * oa
        assert (bp.passes, bp.rows, bp.threads, bp.out_atoms) == (2, 64, 384, oa)
        assert bp.resident == (not f32 and d <= 384) and bp.max_registers == 168
        assert bp.dq_grid == bp.dkdv_grid == (16 * b_chunks, 8, 4)
        assert max(bp.dq_smem_bytes, bp.dkdv_smem_bytes, bp.dv_smem_bytes) <= SMEM_LIMIT
        if not f32:  # the O ring holds a tile's atoms of the block's chunk and one more
            assert min(bp.stages, bp.dkdv_stages) > min(atoms, 2 * oa)


def test_no_head_dim_reaches_the_shared_memory_bound():
    """Shared memory is the only bound below the wrappers; no d reaches it.
    Past 1024 columns (more chunks than a cluster takes) the forwards stream
    every atom through the wide kernels' ring, whose shared memory does not
    grow with d."""
    for d in (257, 1000, 1024):
        assert max(pa.forward_plan(1, 64, 64, 1, d).smem_bytes,
                   fa.f32_plan(1, 64, 64, 1, d).smem_bytes) <= SMEM_LIMIT
    sizes = {(p.smem_bytes, f.smem_bytes, b.dq_smem_bytes, b.dkdv_smem_bytes)
             for d in (1032, 4096, 65536)
             for p, f, b in [(pa.forward_plan(1, 64, 64, 1, d), fa.f32_plan(1, 64, 64, 1, d),
                              pa.backward_plan(1, 64, 64, 1, d))]}
    assert len(sizes) == 1 and max(next(iter(sizes))) <= SMEM_LIMIT
    for d in (1032, 4096):
        p, f = pa.forward_plan(1, 64, 64, 1, d), fa.f32_plan(1, 64, 64, 1, d)
        assert (p.cluster, p.splits, p.stages, f.cluster, f.stages) == (1, 1, fa.WIDE_STAGES, 1,
                                                                        fa.WIDE_STAGES)
    fa.check_head_dim(65536)
    with pytest.raises(ValueError, match="head_dim"):
        fa.check_head_dim(0)
