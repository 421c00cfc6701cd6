"""The attention kernels at every head dim and length the TPU kernels take.

SD-1.5's geometry (8 heads at 320/640/1280 channels: head dims 40/80/160),
the SD levels at 768x768 (9216 and 2304 tokens), and any head dim from 1 to
256 (36: not a multiple of 8, zero-padded for the CUDA kernels; 200 and
256: four 64-column atoms). On the CPU:

* the port's plain versions of B1, B2a, B2b and B3 against the JAX kernels
  in interpret mode at d = 40, 80, 160, 36, 200 and 256;
* a tiny UNet with SD-1.5's traits (heads of 40 and 80 columns, conv
  projections) through a 2-step ControlNet ``generate`` in both packages,
  on the same weights and latents, its long self-attentions routed to the
  packed wrapper as JAX routes them to its Pallas kernel;
* the wrappers' input checks and the launch plans at the new shapes (pure
  Python: they need no card).

The CUDA kernels are held to these plain versions on the card in
test_torch_cuda_kernels.py and chip_smoke.py phase 15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.diffusion.pipeline import SDControlNetPipeline as JaxPipeline
from genima_tpu.kernels.flash_attention import flash_attention as jax_flash
from genima_tpu.kernels.packed_attention import _forward_with_lse
from genima_tpu.kernels.packed_attention import packed_flash_attention as jax_packed
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig
from genima_tpu.nn.unet import UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import VAEConfig as JaxVAEConfig

import genima_torch.nn.layers as torch_layers
from chip_smoke import SD15_LEVELS, SD15_TRAIN_LEVELS, SD768_LEVELS, SD768_TRAIN_LEVELS
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.kernels import flash_attention as fa
from genima_torch.kernels import packed_attention as pa
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig

HEAD_DIMS = [40, 80, 160, 36, 200, 256]
# the tolerances of test_torch_packed_attention.py (B1, f32), of
# test_torch_packed_attention_bwd.py (B2a's o and L; the custom VJP's
# gradients) and of test_torch_flash_attention.py (B3): f32 sums in another
# order than the interpret-mode kernels'
B1_ATOL = 2e-5
LSE_ATOL = 1e-5
VJP_ATOL = 2e-4
B3_ATOL = 1e-5
TARGET_LSB = 1  # the uint8 target, as test_torch_fused_step.py holds it
SMEM_LIMIT = 232448  # what the H100 gives one block: 227 KB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _packed(b, sq, sk, c, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, c).astype(np.float32) for s in (sq, sk, sk)[:n]]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b1_plain_version_matches_pallas_kernel(d):
    q, k, v = _packed(1, 256, 256, 2 * d, seed=d)
    want = jax_packed(*map(jnp.asarray, (q, k, v)), 2)
    got = pa.packed_attention_reference(*map(torch.from_numpy, (q, k, v)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=B1_ATOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b2a_plain_version_matches_pallas_kernel(d):
    q, k, v = _packed(1, 256, 256, 2 * d, seed=d + 1)
    want_o, want_l = _forward_with_lse(*map(jnp.asarray, (q, k, v)), 2, 128, True)
    got_o, got_l = pa.packed_attention_forward_lse(*map(torch.from_numpy, (q, k, v)), 2)
    assert got_l.shape == (1, 256, 2)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=LSE_ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=LSE_ATOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_b2b_autograd_matches_jax_custom_vjp(d):
    """``PackedFlashAttention`` (B2a forward, B2b backward, no fallback)
    against ``jax.grad`` through the JAX custom VJP (``_bwd_kernel``)."""
    q, k, v = _packed(1, 256, 256, 2 * d, seed=d + 2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fallbacks = pa.PackedFlashAttention.fallbacks
    out = pa.packed_flash_attention(*leaves, 2)
    assert type(out.grad_fn).__name__ == "PackedFlashAttentionBackward"
    (out ** 2).sum().backward()
    assert pa.PackedFlashAttention.fallbacks == fallbacks

    def loss(q, k, v):
        return (jax_packed(q, k, v, 2) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, x, y in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), atol=VJP_ATOL, err_msg=name)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("sq,sk", [(128, 128), (100, 77)])
def test_b3_plain_version_matches_pallas_kernel(d, sq, sk):
    """Self-attention, and cross-attention over the 77 prompt tokens."""
    rng = np.random.RandomState(d + sk)
    q, k, v = (rng.randn(1, s, 2, d).astype(np.float32) for s in (sq, sk, sk))
    want = jax_flash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=32)
    got = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=B3_ATOL)


# a tiny UNet with SD-1.5's traits: 2 heads of 40 columns at level 0 (1024
# tokens at 32x32 latents) and of 80 in the mid block (256 tokens), conv
# projections; both lengths take the fused route in both packages
TINY_SD15 = dict(block_out_channels=(80, 160), num_heads=(2, 2), use_linear_projection=False)
STEPS = 2
RESOLUTION = 64


@pytest.fixture(scope="module")
def sd15_like():
    rng = np.random.RandomState(0)
    inputs = dict(
        tiled=rng.randint(0, 256, (1, RESOLUTION, RESOLUTION, 3)).astype(np.uint8),
        latents=rng.randn(1, 32, 32, 4).astype(np.float32),
        embeds=rng.randn(1, 77, 32).astype(np.float32),
    )
    pipe = JaxPipeline(unet_cfg=JaxUNetConfig.tiny(sample_size=32, **TINY_SD15),
                       vae_cfg=JaxVAEConfig.tiny_test(), text_cfg=JaxCLIPConfig.tiny(),
                       dtype=jnp.float32)
    params = pipe.init_params(jax.random.key(0), image_size=RESOLUTION)
    # the ControlNet's zero convs start at zero; randomise them so its
    # residuals shape the output
    cn = dict(params["controlnet"])
    for k in cn:
        if k.startswith("controlnet_"):
            cn[k] = jax.tree_util.tree_map(
                lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), cn[k])
    params["controlnet"] = cn
    target = pipe.generate(params, jnp.asarray(inputs["tiled"]), jnp.asarray(inputs["embeds"]),
                           jnp.asarray(inputs["latents"]), num_inference_steps=STEPS)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    return inputs, tree, np.asarray(target)


def test_sd15_like_generate_matches_jax(sd15_like, monkeypatch):
    inputs, tree, want = sd15_like
    pipe = SDControlNetPipeline(unet_cfg=UNetConfig.tiny(**TINY_SD15),
                                vae_cfg=VAEConfig.tiny_test(), text_cfg=CLIPTextConfig.tiny(),
                                device="cpu")
    params = pipe.params_from_jax(tree)
    routed = []

    def counting(q, k, v, num_heads):
        routed.append((q.shape[1], q.shape[2] // num_heads))
        return pa.packed_flash_attention(q, k, v, num_heads)

    monkeypatch.setattr(torch_layers, "packed_flash_attention", counting)
    got = pipe.generate(params, torch.from_numpy(inputs["tiled"]),
                        torch.from_numpy(inputs["embeds"]), torch.from_numpy(inputs["latents"]),
                        num_inference_steps=STEPS)
    assert got.dtype == torch.uint8 and got.shape == (1, RESOLUTION, RESOLUTION, 3)
    # per denoise step: UNet level 0 (1 down + 2 up) and mid, ControlNet
    # level 0 and mid; head dims 40 and 80
    assert sorted(routed) == sorted([(1024, 40)] * 4 * STEPS + [(256, 80)] * 2 * STEPS)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= TARGET_LSB, f"target differs by {diff.max()} LSB"


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("b,sq,sk,c,h,match", [
    (1, 256, 256, 80, 2, None),      # d 40
    (1, 256, 256, 160, 2, None),     # d 80
    (1, 256, 256, 320, 2, None),     # d 160
    (1, 9216, 9216, 320, 5, None),   # 768x768, level 0
    (1, 256, 256, 336, 2, None),     # d 168: three atoms
    (1, 256, 256, 72, 2, None),      # d 36: zero-padded to 40 for the kernels
    (1, 256, 256, 528, 2, None),         # d 264: five atoms, the wide kernels
    (1, 256, 256, 100, 3, "split"),      # 100 channels do not split into 3 heads
    (1, 9248, 9248, 320, 5, "multiple of 64"),
])
def test_packed_input_checks_take_the_new_shapes(b, sq, sk, c, h, match):
    q, k = _bf16(b, sq, c), _bf16(b, sk, c)
    if match is None:
        pa._check_cuda_inputs(q, k, k, h)
        assert pa.kernel_tiles(q, k)
        return
    with pytest.raises(ValueError, match=match):
        pa._check_cuda_inputs(q, k, k, h)


@pytest.mark.parametrize("d,match", [(40, None), (80, None), (160, None), (8, None),
                                     (168, None), (36, None), (264, None),
                                     (0, "head_dim")])
def test_flash_input_checks_take_the_new_head_dims(d, match):
    q = _bf16(1, 64, 8, d)
    if match is None:
        fa._check_cuda_inputs(q, q, q)
        return
    with pytest.raises(ValueError, match=match):
        fa._check_cuda_inputs(q, q, q)


# every B1/B2a/B2b shape of phase 15 (SD-1.5 at batch 1 and 4, the 768x768
# levels at batch 1 and 4) and SD at 1024x1024 (16384 tokens)
PACKED_SHAPES = SD15_LEVELS + SD15_TRAIN_LEVELS + SD768_LEVELS + SD768_TRAIN_LEVELS + [
    (1, 16384, 320, 5), (4, 16384, 320, 5)]


@pytest.mark.parametrize("b,s,c,h", PACKED_SHAPES)
def test_forward_and_backward_plans_take_the_new_shapes(b, s, c, h):
    d = c // h
    p = pa.forward_plan(b, s, s, h, d)
    assert (p.nwg, p.bn) in pa.forward_tiles(d) and p.atoms == fa.head_atoms(d)
    assert p.grid == (-(-s // p.rows), h, b) and p.kv_tiles * p.bn == s
    assert 2 <= p.stages <= fa.MAX_STAGES and p.smem_bytes <= SMEM_LIMIT
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= fa.SMEM_SM
    assert p.blocks_per_sm * p.threads * p.max_registers <= fa.REGISTERS_SM
    bp = pa.backward_plan(b, s, s, h, d)
    assert bp.dq_grid == bp.dkdv_grid == (-(-s // pa.BWD_BLOCK_ROWS), h, b)
    assert max(bp.dq_smem_bytes, bp.dkdv_smem_bytes) <= SMEM_LIMIT
    assert bp.passes == (1 if d <= 64 else 2)


def test_wide_heads_take_their_own_tiles_and_as_deep_a_ring_as_fits():
    # d 160: three atoms, 64-key tiles; two warpgroups for a long key loop
    p = pa.forward_plan(1, 256, 256, 8, 160)
    assert (p.nwg, p.bn, p.atoms, p.stages) == (2, 64, 3, 3)
    p = pa.forward_plan(1, 4096, 4096, 8, 40)  # one atom: SD's rules
    assert (p.nwg, p.bn, p.atoms) == (2, 128, 1)
    p = fa.plan(1, 256, 77, 8, 160)  # the prompt in one 80-key tile
    assert (p.nwg, p.bn, p.kv_tiles, p.stages) == (1, 80, 1, 1)
    with pytest.raises(ValueError, match="no kernel"):
        pa.make_forward_plan(1, 1024, 1024, 8, 2, 128, d=80)
    with pytest.raises(ValueError, match="stages"):
        pa.make_forward_plan(1, 1024, 1024, 8, 2, 64, stages=4, d=160)
    for d, stages in ((40, 4), (80, 4), (160, 2)):
        assert pa.backward_plan(4, 4096, 4096, 8, d).stages == stages


@pytest.mark.parametrize("sq,sk,h,d", [(4096, 4096, 8, 40), (1024, 77, 8, 80),
                                       (256, 256, 8, 160), (64, 77, 8, 160),
                                       (9216, 9216, 5, 64)])
def test_flash_plan_takes_the_new_shapes(sq, sk, h, d):
    p = fa.plan(1, sq, sk, h, d)
    assert (p.nwg, p.bn) in fa.tiles_for(d)
    assert p.kv_tiles * p.bn >= sk > (p.kv_tiles - 1) * p.bn
    assert p.smem_bytes == fa.smem_bytes(p.nwg, p.bn, p.stages, p.atoms) <= SMEM_LIMIT


# four atoms (d 200..256) and dims that are not a multiple of 8, at the
# shapes the card tests and chip_smoke.py give the kernels
ANY_D_SHAPES = [(b, s, h, d) for d in (1, 7, 36, 100, 168, 200, 256)
                for b, s, h in ((2, 320, 3), (4, 4096, 8), (1, 9216, 5))]


@pytest.mark.parametrize("b,s,h,d", ANY_D_SHAPES)
def test_plans_at_any_head_dim_fit_the_card(b, s, h, d):
    """B1/B2a's, B3's and B2b's plans read a head as the atoms of its
    zero-padded width and fit the 227 KB a block may take and the 255
    registers a thread may hold; four atoms take one consumer warpgroup."""
    atoms = fa.head_atoms(fa.padded_head_dim(d))
    assert atoms == fa.head_atoms(d) and fa.padded_head_dim(d) % 8 == 0
    for p in (pa.forward_plan(b, s, s, h, d), fa.plan(b, s, s, h, d), fa.plan(b, s, 77, h, d)):
        assert p.atoms == atoms and p.smem_bytes <= SMEM_LIMIT
        assert p.blocks_per_sm * (p.smem_bytes + 1024) <= fa.SMEM_SM
        assert p.blocks_per_sm * p.threads * p.max_registers <= fa.REGISTERS_SM
        assert p.max_registers <= 255
        assert p.stages >= (2 if p.kv_tiles > 1 else 1)
        if atoms == 4:
            # 128 f32 of O a thread: one warpgroup, 160 threads, 255 registers
            assert (p.nwg, p.threads, p.max_registers) == (1, 160, 255)
    bp = pa.backward_plan(b, s, s, h, d)
    assert max(bp.dq_smem_bytes, bp.dkdv_smem_bytes) <= SMEM_LIMIT and bp.max_registers <= 255
    assert bp.dq_grid == bp.dkdv_grid == (-(-s // bp.rows), h, b)
    if atoms == 4:
        assert (bp.rows, bp.threads, bp.stages, bp.max_registers) == (64, 160, 2, 255)
    else:
        assert bp.threads * bp.max_registers <= fa.REGISTERS_SM and bp.rows == pa.BWD_BLOCK_ROWS


@pytest.mark.parametrize("d", [1, 7, 36, 100, 200, 256])
@pytest.mark.parametrize("h", [1, 3])
def test_padded_heads_round_trip(d, h):
    """The wrappers' zero-padding of each head to the next multiple of 8
    columns keeps the real columns in place and zeros the rest."""
    x = torch.randn(2, 5, h * d)
    p = fa.pad_heads(x, d)
    dp = fa.padded_head_dim(d)
    assert p.shape == (2, 5, h * dp) and p.is_contiguous()
    heads = p.view(2, 5, h, dp)
    assert torch.equal(heads[..., :d], x.view(2, 5, h, d))
    assert not heads[..., d:].any()
    back = fa.unpad_heads(p, d)
    assert back.is_contiguous() and torch.equal(back, x)
