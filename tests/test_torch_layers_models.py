"""Layer- and model-level parity of the port against the JAX package, f32.

Each JAX module gets random params (``fast_init``), the port's counterpart
loads them through the port's converter, and both run the same numpy
inputs. Layouts: the JAX side is NHWC, the port NCHW inside its modules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genima_tpu.control.policy import GenimaACTAgent as JaxACTAgent
from genima_tpu.core.init_utils import fast_init
from genima_tpu.nn import layers as jl
from genima_tpu.nn.act import ACTConfig as JaxACTConfig, GenimaACTModel as JaxACT
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig, CLIPTextModel as JaxCLIP
from genima_tpu.nn.controlnet import ControlNetModel as JaxControlNet
from genima_tpu.nn.resnet import ImageEncoderACT as JaxEncoder
from genima_tpu.nn.unet import UNet2DConditionModel as JaxUNet, UNetConfig as JaxUNetConfig
from genima_tpu.nn.vae import AutoencoderKL as JaxVAE, VAEConfig as JaxVAEConfig

from genima_torch.control.policy import GenimaACTAgent
from genima_torch.nn import layers as tl
from genima_torch.nn.act import ACTConfig, GenimaACTModel
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.controlnet import ControlNetModel, embed_conditioning
from genima_torch.nn.resnet import ImageEncoderACT
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import DECODE_SUBTREES, AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import drop_subtrees, load_from_jax
from genima_torch.weights.init import build_module

ATOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(factory, tree, family):
    module = build_module(factory, CPU, torch.float32)
    return load_from_jax(module, jax.tree_util.tree_map(np.asarray, tree), family)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.mark.parametrize("flip", [True, False])
def test_timestep_embedding(flip):
    t = np.array([0.0, 17.0, 999.0], np.float32)
    want = jl.get_timestep_embedding(jnp.asarray(t), 64, flip_sin_to_cos=flip)
    got = tl.get_timestep_embedding(torch.from_numpy(t), 64, flip_sin_to_cos=flip)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("channels", [320, 48, 16, 8])
def test_group_norm_groups(channels):
    assert tl.group_norm(channels, 1e-6).num_groups == jl.group_norm(
        channels, 1e-6, jnp.float32, "n"
    ).num_groups


ATTN_CASES = {
    # (tokens, query_dim, heads, cross_dim): 256 self tokens take the packed
    # kernel (Pallas interpret mode on the JAX side), the others do not
    "self_packed": (256, 128, 2, None),
    "self_short": (64, 128, 2, None),
    "cross": (128, 64, 2, 48),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case):
    sq, dim, heads, cross = ATTN_CASES[case]
    rng = np.random.RandomState(1)
    x = rng.randn(2, sq, dim).astype(np.float32)
    ctx = rng.randn(2, 77, cross).astype(np.float32) if cross else None
    jm = jl.Attention(dim, heads, cross_attention_dim=cross, backend="fused")
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    p = fast_init(jm, jax.random.key(0), *args, seed=3)["params"]
    tm = _port(lambda: tl.Attention(dim, heads, cross, "fused"), p, "diffusers_unet")
    targs = (torch.from_numpy(x),) + ((torch.from_numpy(ctx),) if cross else ())
    _close(tm(*targs).detach(), jm.apply({"params": p}, *args))


def test_attention_backend_switch():
    """'xla' sends every attention to the library call; 'fused' sends long
    self-attention to the packed wrapper, 'pallas' every attention to the
    flash wrapper. On the CPU all compute the same function; an unknown
    backend, or '+w8' on float linears, raises."""
    torch.manual_seed(0)
    block = build_module(lambda: tl.BasicTransformerBlock(128, 2, 48), CPU, torch.float32)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x, ctx = torch.randn(1, 256, 128), torch.randn(1, 77, 48)
    fused = block(x, ctx)
    for backend in ("xla", "pallas", "pallas_self"):
        tl.set_attention_backend(block, backend)
        assert {m.backend for m in block.modules() if isinstance(m, tl.Attention)} == {backend}
        torch.testing.assert_close(block(x, ctx), fused, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="backend"):
        tl.set_attention_backend(block, "flash")
    with pytest.raises(ValueError, match="backend"):
        tl.set_attention_backend(block, "xla+w8")


def test_transformer2d_token_order():
    """h != w pins the row-major (h, w) token order; 256 tokens with
    head_dim 64 take the packed path."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 8, 32, 128).astype(np.float32)  # NHWC
    ctx = rng.randn(1, 77, 48).astype(np.float32)
    jm = jl.Transformer2DModel(128, 2, 48, backend="fused")
    p = fast_init(jm, jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx), seed=4)["params"]
    tm = _port(lambda: tl.Transformer2DModel(128, 2, 48), p, "diffusers_unet")
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx))
    _close(_nhwc(tm(_nchw(x), torch.from_numpy(ctx))), want)


@pytest.mark.parametrize("in_ch,out_ch,temb", [(32, 64, True), (16, 16, False)])
def test_resnet_block(in_ch, out_ch, temb):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, in_ch).astype(np.float32)
    e = rng.randn(2, 128).astype(np.float32)
    jm = jl.ResnetBlock2D(out_ch, use_time_emb=temb)
    args = (jnp.asarray(x),) + ((jnp.asarray(e),) if temb else ())
    p = fast_init(jm, jax.random.key(0), *args, seed=5)["params"]
    tm = _port(lambda: tl.ResnetBlock2D(in_ch, out_ch, 128 if temb else None), p,
               "diffusers_unet")
    targs = (_nchw(x),) + ((torch.from_numpy(e),) if temb else ())
    _close(_nhwc(tm(*targs)), jm.apply({"params": p}, *args))


@pytest.mark.parametrize("kind", ["down", "up"])
def test_sampling_blocks(kind):
    x = np.random.RandomState(4).randn(1, 6, 6, 8).astype(np.float32)
    jm = jl.Downsample2D(8) if kind == "down" else jl.Upsample2D(8)
    p = fast_init(jm, jax.random.key(0), jnp.asarray(x), seed=6)["params"]
    factory = (lambda: tl.Downsample2D(8)) if kind == "down" else (lambda: tl.Upsample2D(8))
    tm = _port(factory, p, "diffusers_unet")
    _close(_nhwc(tm(_nchw(x))), jm.apply({"params": p}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet_pair():
    cfg = JaxUNetConfig.tiny()
    jm = JaxUNet(cfg, backend="fused")
    p = fast_init(
        jm, jax.random.key(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, cfg.cross_attention_dim)), seed=11,
    )["params"]
    tm = _port(lambda: UNet2DConditionModel(UNetConfig.tiny()), p, "diffusers_unet")
    return jm, p, tm


def test_unet_forward(unet_pair):
    """16x16 latents: the 256-token level-0 self-attention takes the packed path."""
    jm, p, tm = unet_pair
    rng = np.random.RandomState(0)
    sample = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.array([999.0, 17.0], np.float32)
    ctx = rng.randn(2, 4, 32).astype(np.float32)
    want = jm.apply({"params": p}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    got = tm(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx))
    _close(_nhwc(got), want)


@pytest.mark.parametrize("embedded", [False, True])
def test_controlnet_into_unet(unet_pair, embedded):
    jun, up, tun = unet_pair
    cfg = JaxUNetConfig.tiny()
    jcn = JaxControlNet(cfg, conditioning_scale_channels=(8, 16), backend="fused")
    cp = fast_init(
        jcn, jax.random.key(1), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 32)), jnp.zeros((1, 32, 32, 3)), seed=12,
    )["params"]
    rng = np.random.RandomState(5)  # zero convs -> random, so residuals matter
    cp = {
        k: jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), v
        ) if k.startswith("controlnet_") else v
        for k, v in cp.items()
    }
    tcn = _port(lambda: ControlNetModel(UNetConfig.tiny(), (8, 16)), cp,
                "diffusers_controlnet")
    sample = rng.randn(1, 16, 16, 4).astype(np.float32)
    t = np.array([499.0], np.float32)
    ctx = rng.randn(1, 4, 32).astype(np.float32)
    cond = rng.rand(1, 32, 32, 3).astype(np.float32)
    down, mid = jcn.apply({"params": cp}, jnp.asarray(sample), jnp.asarray(t),
                          jnp.asarray(ctx), jnp.asarray(cond), conditioning_scale=0.7)
    eps = jun.apply({"params": up}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx),
                    down_block_additional_residuals=down,
                    mid_block_additional_residual=mid)
    tcond = _nchw(cond)
    if embedded:
        tcond = embed_conditioning(tcn, tcond)
    tdown, tmid = tcn(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx), tcond,
                      conditioning_scale=0.7, cond_is_embedded=embedded)
    teps = tun(_nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx),
               down_block_additional_residuals=tdown, mid_block_additional_residual=tmid)
    for d, td in zip(down, tdown):
        _close(_nhwc(td), d)
    _close(_nhwc(tmid), mid)
    _close(_nhwc(teps), eps)


def test_vae_decode():
    cfg = JaxVAEConfig.tiny_test()
    jm = JaxVAE(cfg)
    p = fast_init(jm, jax.random.key(3), jnp.zeros((1, 16, 16, 3)), jax.random.key(4),
                  seed=13)["params"]
    tm = _port(lambda: AutoencoderKL(VAEConfig.tiny_test()),
               drop_subtrees(p, DECODE_SUBTREES, keep=True), "diffusers_vae")
    z = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    want = jm.apply({"params": p}, jnp.asarray(z), method=jm.decode)
    _close(_nhwc(tm.decode(_nchw(z))), want)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text(act):
    jcfg = JaxCLIPConfig.tiny(hidden_act=act)
    jm = JaxCLIP(jcfg)
    p = fast_init(jm, jax.random.key(0), jnp.zeros((1, 77), jnp.int32), seed=14)["params"]
    tm = _port(lambda: CLIPTextModel(CLIPTextConfig.tiny(hidden_act=act)), p, "hf_clip")
    ids = np.random.RandomState(6).randint(0, 1200, (2, 77)).astype(np.int32)  # some out of vocab
    want = jm.apply({"params": p}, jnp.asarray(ids))
    got = tm(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        _close(g.detach(), w)


@pytest.mark.parametrize("small_inputs", [False, True])
def test_image_encoder_and_actor(small_inputs):
    jcfg = JaxACTConfig.tiny(num_queries=6)
    rng = np.random.RandomState(7)
    images = rng.randn(1, 4, 32, 32, 3).astype(np.float32)
    lang = rng.randn(1, 16).astype(np.float32)
    qpos = rng.randn(1, 8).astype(np.float32)
    jenc = JaxEncoder(hidden_dim=32, width=8, small_inputs=small_inputs)
    ep = fast_init(jenc, jax.random.key(0), jnp.asarray(images), jnp.asarray(lang),
                   seed=15)["params"]
    tokens, pos = jenc.apply({"params": ep}, jnp.asarray(images), jnp.asarray(lang))
    jact = JaxACT(jcfg)
    ap = fast_init(
        jact, {"params": jax.random.key(1), "dropout": jax.random.key(1)}, tokens, pos,
        jnp.asarray(qpos), jnp.zeros((1, 6, 8)), jnp.zeros((1, 6), bool),
        jnp.asarray(lang), latent_key=jax.random.key(2), train=True, seed=16,
    )["params"]
    want = jact.apply({"params": ap}, tokens, pos, jnp.asarray(qpos),
                      task_emb=jnp.asarray(lang), train=False)

    tenc = _port(lambda: ImageEncoderACT(32, True, 8, small_inputs, 16), ep,
                 "torchvision_resnet")
    ttok, tpos = tenc(torch.from_numpy(images).permute(0, 1, 4, 2, 3),
                      torch.from_numpy(lang))
    _close(ttok.detach(), tokens)
    _close(tpos, pos)
    tact = _port(lambda: GenimaACTModel(ACTConfig.tiny(num_queries=6)), ap, "act")
    got = tact(ttok, tpos, torch.from_numpy(qpos), task_emb=torch.from_numpy(lang))
    _close(got.actions.detach(), want.actions)
    _close(got.is_pad_logits.detach(), want.is_pad_logits)


def test_act_agent_inference():
    """ImageNet normalisation + CLIP language + encoder + actor, end to end."""
    jagent = JaxACTAgent(
        act_cfg=JaxACTConfig.tiny(num_queries=6),
        clip_cfg=JaxCLIPConfig.tiny(projection_dim=16),
        image_size=32, resnet_width=8, num_views=4, data_augmentation=False,
    )
    params, clip_p = jagent.init_params(jax.random.key(0))
    jagent.create_state(params, clip_p)
    agent = GenimaACTAgent(
        act_cfg=ACTConfig.tiny(num_queries=6),
        clip_cfg=CLIPTextConfig.tiny(projection_dim=16), resnet_width=8, device="cpu",
    )
    tparams, tclip = agent.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, clip_p)
    )
    rng = np.random.RandomState(8)
    images = rng.uniform(0, 255, (1, 4, 32, 32, 3)).astype(np.float32)
    qpos = rng.randn(1, 8).astype(np.float32)
    ids = rng.randint(0, 1000, (1, 77)).astype(np.int32)
    want = jagent.act(params, jnp.asarray(images), jnp.asarray(qpos), jnp.asarray(ids))
    got = agent.act(tparams, torch.from_numpy(images), torch.from_numpy(qpos),
                    torch.from_numpy(ids))
    assert got.shape == (1, 6, 8)
    _close(got, want)
    _close(agent.encode_lang(tclip, ids).detach(),
           jagent.encode_lang(clip_p, jnp.asarray(ids)))
