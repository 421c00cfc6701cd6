"""The port's ACT training half against the JAX package's, f32, on the CPU.

Every draw is made in the test and handed to both packages: the latent
noise comes from JAX's own key split (``_loss``: augmentation, latent,
dropout), the augmentation's parameters from the keys its ops split, and
dropout masks from a stand-in for ``flax.linen.Dropout`` (patched in the
test only) that the port replays in the same order. Tolerances: 1e-5 on
the train forward (relative to each output's norm) and on the updates
(relative to the norm of all params, and of each group's first moments and
the roots of its second moments), each tensor's update or moment 1e-3; 1e-6
on the loss, 1e-4 on [0, 255] images where the ops are elementwise (noise,
crop, the random_apply branches); where the elastic warp or colour jitter
applies, ``test_torch_augment``'s 1e-5 on [0, 1], i.e. 2.55e-3 on [0, 255]
(the elastic field's 41-tap smoothing sums in another order: 2.8e-6 on
[0, 1], 8e-4 on [0, 255]).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genima_tpu.control import policy as jpolicy
from genima_tpu.control.replay import EpochReplayBuffer as JaxReplay
from genima_tpu.core.init_utils import fast_init
from genima_tpu.data import augment as jaug
from genima_tpu.nn import act as jact
from genima_tpu.nn.clip_text import CLIPTextConfig as JaxCLIPConfig

from genima_torch.control import policy
from genima_torch.control.replay import EpochReplayBuffer
from genima_torch.data import augment as aug
from genima_torch.nn import act
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.weights.init import build_module
from genima_torch.weights.from_jax import load_from_jax

B, V, HW, T = 3, 4, 32, 8
NQ = 6
REL = 1e-5


# -- dropout stand-in for the JAX package ----------------------------------------------


class _Masks:
    """Masks for the patched flax Dropout, in call order: all-keep, or drawn
    from a numpy RNG; each call's (shape, rate, mask) is recorded."""

    def __init__(self, rng=None):
        self.rng, self.calls = rng, []

    def __call__(self, shape, rate):
        if self.rng is None:
            keep = np.ones(shape, bool)
        else:
            keep = self.rng.uniform(size=shape) < 1.0 - rate
        self.calls.append((tuple(shape), rate, keep))
        return keep


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: the suite runs files in
    parallel workers, and a pool of spinning threads per worker at these
    sizes costs far more time than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _patch_flax_dropout(monkeypatch, masks: _Masks):
    class MaskDropout(fnn.Module):
        rate: float
        deterministic: bool | None = None

        @fnn.compact
        def __call__(self, x, deterministic=None):
            det = fnn.merge_param("deterministic", self.deterministic, deterministic)
            if det or self.rate == 0.0:
                return x
            keep = jnp.asarray(masks(x.shape, self.rate))
            return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))

    monkeypatch.setattr(fnn, "Dropout", MaskDropout)


class _PortMasks:
    """The port's mask source replaying ``_Masks.calls`` and recording its own."""

    def __init__(self, calls=None):
        self.calls, self._want = [], iter(calls) if calls is not None else None

    def __call__(self, shape, rate, device):
        self.calls.append((tuple(shape), rate))
        if self._want is None:
            return torch.ones(shape, dtype=torch.bool)
        return torch.from_numpy(next(self._want)[2])


def _all_keep(shape, rate, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    is_pad = np.zeros((B, T), bool)
    is_pad[0, 5:] = True
    is_pad[2, 7:] = True
    return {
        "images": rng.uniform(0, 255, (B, V, HW, HW, 3)).astype(np.float32),
        "qpos": rng.randn(B, 8).astype(np.float32),
        "actions": np.concatenate([rng.randn(B, T, 7), rng.randint(0, 2, (B, T, 1))],
                                  -1).astype(np.float32),
        "is_pad": is_pad,
        "lang_tokens": rng.randint(0, 1000, (B, 77)).astype(np.int32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# -- the actor ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def actor_inputs():
    cfg = jact.ACTConfig.tiny(num_queries=NQ)
    rng = np.random.RandomState(3)
    inputs = {
        "tokens": rng.randn(B, 10, 32).astype(np.float32),
        "pos": rng.randn(1, 10, 32).astype(np.float32),
        "qpos": rng.randn(B, 8).astype(np.float32),
        "actions": _batch()["actions"],
        "is_pad": _batch()["is_pad"],
        "lang": rng.randn(B, 16).astype(np.float32),
    }
    model = jact.GenimaACTModel(cfg)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = fast_init(
        model, {"params": jax.random.key(1), "dropout": jax.random.key(1)}, j["tokens"],
        j["pos"], j["qpos"], j["actions"], j["is_pad"], j["lang"],
        latent_key=jax.random.key(2), train=True, seed=16)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = build_module(lambda: act.GenimaACTModel(act.ACTConfig.tiny(num_queries=NQ)),
                        torch.device("cpu"), torch.float32)
    load_from_jax(port, params, "act")
    return model, params, port, inputs


def _train_forward(actor_inputs, jax_masks, port_masks, key=jax.random.key(5)):
    model, params, port, x = actor_inputs
    # traced once per call, so the patched Dropout's masks are constants
    want = jax.jit(lambda p, *a: model.apply(
        {"params": p}, *a[:3], actions=a[3], is_pad=a[4], task_emb=a[5], latent_key=key,
        train=True))(params, *(jnp.asarray(x[k]) for k in
                               ("tokens", "pos", "qpos", "actions", "is_pad", "lang")))
    eps = np.array(jax.random.normal(key, (B, 8)))
    got = port(*(torch.from_numpy(x[k]) for k in ("tokens", "pos", "qpos")),
               task_emb=torch.from_numpy(x["lang"]), actions=torch.from_numpy(x["actions"]),
               latent_eps=torch.from_numpy(eps), dropout_masks=port_masks)
    return got, want


def test_train_forward_matches_jax(actor_inputs, monkeypatch):
    """mu, logvar, actions and pad logits with the style encoder, the latent
    noise injected and every dropout site keeping everything."""
    masks = _Masks()
    _patch_flax_dropout(monkeypatch, masks)
    got, want = _train_forward(actor_inputs, masks, _all_keep)
    for name in ("mu", "logvar", "actions", "is_pad_logits"):
        g = getattr(got, name).detach().numpy()
        assert g.shape == np.shape(getattr(want, name))
        assert _rel(g, getattr(want, name)) <= REL, name
    assert masks.calls  # the patched sites ran


def test_dropout_sites_and_scaling_match_flax(actor_inputs, monkeypatch):
    """Random masks at every flax site, in flax's call order: the port asks
    for the same shapes and rates and, given the same masks, computes the
    same outputs; kept values are scaled by 1 / keep."""
    masks = _Masks(np.random.RandomState(9))
    _patch_flax_dropout(monkeypatch, masks)
    port_masks = _PortMasks(masks.calls)
    got, want = _train_forward(actor_inputs, masks, port_masks)
    assert port_masks.calls == [(s, r) for s, r, _ in masks.calls]
    c = act.ACTConfig.tiny(num_queries=NQ)
    # proprio + per encoder layer (style and DETR) 4 + per decoder layer 6
    assert len(masks.calls) == 1 + 2 * c.enc_layers * 4 + c.dec_layers * 6
    assert masks.calls[0][1] == act.PROPRIO_DROPOUT
    for name in ("mu", "logvar", "actions", "is_pad_logits"):
        assert _rel(getattr(got, name).detach().numpy(), getattr(want, name)) <= REL, name

    x = torch.arange(1.0, 9.0)
    keep = torch.tensor([True, False] * 4)
    out = act.dropout(x, 0.2, lambda shape, rate, device: keep)
    np.testing.assert_allclose(out.numpy(), np.where(keep, x / 0.8, 0.0), rtol=1e-7)
    assert act.dropout(x, 0.2, None) is x
    drawn = act.RandomDropout(torch.Generator().manual_seed(0), record=True)
    m = act.dropout(torch.ones(100_000), 0.3, drawn)
    assert abs((m > 0).float().mean().item() - 0.7) < 0.01 and len(drawn.masks) == 1


def test_inference_forward_ignores_the_style_encoder(actor_inputs):
    """Without actions the latent is zeros and mu/logvar are None."""
    model, params, port, x = actor_inputs
    want = jax.jit(lambda p, *a: model.apply({"params": p}, *a[:3], task_emb=a[3], train=False))(
        params, *(jnp.asarray(x[k]) for k in ("tokens", "pos", "qpos", "lang")))
    got = port(*(torch.from_numpy(x[k]) for k in ("tokens", "pos", "qpos")),
               task_emb=torch.from_numpy(x["lang"]))
    assert got.mu is None and got.logvar is None
    assert _rel(got.actions.detach().numpy(), want.actions) <= REL


def test_act_loss_matches_jax():
    rng = np.random.RandomState(4)
    out = dict(actions=rng.randn(B, NQ, 8).astype(np.float32),
               is_pad_logits=rng.randn(B, NQ).astype(np.float32),
               mu=rng.randn(B, 8).astype(np.float32), logvar=rng.randn(B, 8).astype(np.float32))
    batch = _batch(1)
    want_loss, want = jact.act_loss(jact.ACTOutput(**{k: jnp.asarray(v) for k, v in out.items()}),
                                    jnp.asarray(batch["actions"]), jnp.asarray(batch["is_pad"]), 10.0)
    got_loss, got = act.act_loss(act.ACTOutput(**{k: torch.from_numpy(v) for k, v in out.items()}),
                                 torch.from_numpy(batch["actions"]),
                                 torch.from_numpy(batch["is_pad"]), 10.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
    assert batch["is_pad"].any()


# -- augmentation ---------------------------------------------------------------------------


def jax_act_augment_draws(key, n, h, w) -> aug.ACTAugmentDraws:
    """The draws ``act_train_augment(key, ...)`` makes, in its ops' own
    split order."""
    k = jax.random.split(key, 4)
    u = jax.random.uniform
    apply, sub = [], []
    for i in range(3):
        kp, kf = jax.random.split(k[i])
        apply.append(bool(jax.random.bernoulli(kp, 0.5)))
        sub.append(kf)
    kx, ky = jax.random.split(sub[0])
    elastic = np.stack([np.asarray(u(kx, (1, h, w, 1), minval=-1.0, maxval=1.0))[0, ..., 0],
                        np.asarray(u(ky, (1, h, w, 1), minval=-1.0, maxval=1.0))[0, ..., 0]])
    kb, kc, ks, kh = jax.random.split(sub[1], 4)
    jitter = np.array([u(kb, (), minval=0.8, maxval=1.2), u(kc, (), minval=0.8, maxval=1.2),
                       u(ks, (), minval=0.9, maxval=1.1), u(kh, (), minval=-0.05, maxval=0.05)],
                      np.float32)
    ky, kx = jax.random.split(sub[2])
    crop = np.array([jax.random.randint(ky, (), 0, 9), jax.random.randint(kx, (), 0, 9)])
    noise = np.array(jax.random.normal(k[3], (n, h, w, 3)))
    return aug.ACTAugmentDraws(tuple(apply), torch.from_numpy(elastic),
                               torch.from_numpy(jitter), torch.from_numpy(crop).long(),
                               torch.from_numpy(noise))


def _key_with(decisions):
    for seed in range(200):
        key = jax.random.key(seed)
        k = jax.random.split(key, 4)
        got = tuple(bool(jax.random.bernoulli(jax.random.split(k[i])[0], 0.5)) for i in range(3))
        if got == decisions:
            return key
    raise AssertionError(decisions)


@pytest.mark.parametrize("decisions", [(True, True, True), (False, False, False),
                                       (True, False, True), (False, False, True)])
def test_act_train_augment_matches_jax(decisions):
    """The whole recipe on [0, 255] images, each random_apply branch taken."""
    images = np.random.RandomState(5).uniform(0, 255, (V, HW, HW + 8, 3)).astype(np.float32)
    key = _key_with(decisions)
    want = jaug.act_train_augment(key, jnp.asarray(images))
    draws = jax_act_augment_draws(key, V, HW, HW + 8)
    assert draws.apply == decisions
    got = aug.act_train_augment(torch.from_numpy(images), draws)
    atol = 255 * 1e-5 if decisions[0] or decisions[1] else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("op", ["noise", "crop_constant", "random_apply"])
def test_act_augment_op_matches_jax(op):
    images = np.random.RandomState(6).uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    key = jax.random.key(11)
    x, xt = jnp.asarray(images), torch.from_numpy(images)
    if op == "noise":
        want = jaug.add_gaussian_noise(key, x, std=5.0)
        got = aug.add_gaussian_noise(xt, torch.from_numpy(np.asarray(jax.random.normal(key, x.shape))))
    elif op == "crop_constant":
        want = jaug.random_crop_with_pad(key, x, padding=4, mode="constant")
        ky, kx = jax.random.split(key)
        offset = torch.tensor([int(jax.random.randint(ky, (), 0, 9)),
                               int(jax.random.randint(kx, (), 0, 9))])
        got = aug.random_crop_with_pad(xt, offset, padding=4, mode="constant")
        assert (np.asarray(want) == 0).any()  # the pad shows
    else:
        kp, _ = jax.random.split(key)
        apply = bool(jax.random.bernoulli(kp, 0.5))
        want = jaug.random_apply(key, lambda k, t: t * 2.0, x)
        got = aug.random_apply(lambda t: t * 2.0, xt, apply)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sampled_act_draws_have_the_jax_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        d = aug.sample_act_augment_draws(5, 12, 16, g)
        seen.add(d.apply)
        assert d.noise.shape == (5, 12, 16, 3)
        if d.apply[0]:
            assert d.elastic.shape == (2, 12, 16) and d.elastic.abs().max() <= 1
        if d.apply[1]:
            lo = torch.tensor([0.8, 0.8, 0.9, -0.05])
            assert ((d.jitter >= lo) & (d.jitter <= lo + torch.tensor([.4, .4, .2, .1]))).all()
        if d.apply[2]:
            assert d.crop.dtype == torch.long and 0 <= d.crop.min() and d.crop.max() <= 8
    assert len(seen) > 4  # the decisions vary


# -- the update ----------------------------------------------------------------------------


def _jax_agent(clip):
    return jpolicy.GenimaACTAgent(
        act_cfg=jact.ACTConfig.tiny(num_queries=NQ), clip_cfg=JaxCLIPConfig.tiny(projection_dim=16),
        image_size=HW, resnet_width=8, num_views=V, data_augmentation=False, lr=1e-3,
        lr_backbone=3e-4, actor_grad_clip=clip)


def _port_agent(clip):
    return policy.GenimaACTAgent(
        act_cfg=act.ACTConfig.tiny(num_queries=NQ), clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
        resnet_width=8, data_augmentation=False, lr=1e-3, lr_backbone=3e-4,
        actor_grad_clip=clip, device="cpu", dtype=torch.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def _jax_moments(opt_state, group: str, which: str) -> dict:
    """path -> moment of ``group`` from optax's chain state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))) for p in path]
        if group in keys and which in keys:
            out[tuple(keys[keys.index(which) + 1:])] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def jax_init():
    """Seeded params (made by the port: the JAX package's own init runs
    flax eagerly and takes as long as an update's compile) and the JAX CLIP
    tower, as the reference's numpy trees."""
    from genima_torch.weights.to_jax import tree_from_module

    params, _ = _port_agent(None).init_params(torch.Generator().manual_seed(0))
    jagent = _jax_agent(None)
    clip = fast_init(jagent.clip, jax.random.key(3), jnp.zeros((1, 77), jnp.int32), seed=13)
    return ({part: tree_from_module(params[part], family)
             for part, family in policy.FAMILIES.items()},
            jax.tree_util.tree_map(np.asarray, clip["params"]))


@pytest.fixture(scope="module", params=[None, 0.05], ids=["no_clip", "clip"])
def two_updates(request, jax_init):
    """Two updates of each package from the same params, batches and draws.
    The clip (0.05) binds: the first step's global norm is far above it."""
    clip = request.param
    init, clip_np = jax_init
    with pytest.MonkeyPatch.context() as mp:
        _patch_flax_dropout(mp, _Masks())
        jagent = _jax_agent(clip)
        state = jagent.create_state(jax.tree_util.tree_map(jnp.asarray, init),
                                    jax.tree_util.tree_map(jnp.asarray, clip_np))
        keys = [jax.random.key(21), jax.random.key(22)]
        batches = [_batch(7), _batch(8)]
        for key, batch in zip(keys, batches):
            state, _ = jagent.update(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jstate = jax.tree_util.tree_map(np.asarray, state)

    agent = _port_agent(clip)
    pstate = agent.create_state(*agent.params_from_jax(init, clip_np))
    norms = []
    for key, batch in zip(keys, batches):
        eps = np.array(jax.random.normal(jax.random.split(key, 3)[1], (B, 8)))
        draws = policy.ACTDraws(None, torch.from_numpy(eps), _all_keep)
        if clip:
            loss, _ = agent.loss(pstate.params, _torch_batch(batch), draws)
            grads = torch.autograd.grad(loss, list(pstate.live.values()), allow_unused=True)
            norms.append(float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads
                                              if g is not None))))
        pstate, metrics = agent.update(pstate, _torch_batch(batch), draws)
    return dict(clip=clip, init=init, jstate=jstate, agent=agent, pstate=pstate, norms=norms,
                metrics=metrics)


def _cat(tree: dict, paths) -> np.ndarray:
    return np.concatenate([np.ravel(tree[p]) for p in paths])


def _gradient_free(jstate) -> set:
    """Tensors whose gradient is zero in exact arithmetic, so that each
    package's f32 gradient is rounding noise (which Adam scales up to steps
    of up to ``lr``): every attention key bias (softmax is shift-invariant),
    the first decoder layer's self-attention projections (its target and so
    its values are zeros), the unused pad head. Found as the tensors whose
    JAX first moment is below 1e-7 of its group's largest."""
    out = set()
    for group in ("main", "backbone"):
        mu = _jax_moments(jstate.opt_state, group, "mu")
        scale = max(np.abs(m).max() for m in mu.values())
        out |= {p for p, m in mu.items() if np.abs(m).max() <= 1e-7 * scale}
    for path in out:
        assert (path[-2:] == ("k_proj", "bias") or path[1:3] == ("decoder_0", "self_attn")
                or path[1] == "is_pad_head"), path
    return out


def test_update_params_match_jax(two_updates):
    want = _flat(two_updates["jstate"].params)
    got = _flat(two_updates["pstate"].tree())
    assert set(got) == set(want)
    init = _flat(two_updates["init"])
    lr = two_updates["agent"].lr
    noise = _gradient_free(two_updates["jstate"])
    assert ("actor", "encoder_0", "self_attn", "k_proj", "bias") in noise
    kept = sorted(set(want) - noise)
    for path in noise:
        assert np.abs(got[path] - init[path]).max() <= 2 * lr, path
    for path in kept:  # each tensor's update, in direction and size
        delta = want[path] - init[path]
        assert _rel(got[path] - init[path], delta) <= 1e-3 or not delta.any(), path
    assert _rel(_cat(got, kept), _cat(want, kept)) <= REL
    if two_updates["clip"]:
        assert min(two_updates["norms"]) > 10 * two_updates["clip"]


def test_labels_match_jax_and_frozen_params_stay(two_updates):
    pstate = two_updates["pstate"]
    labels = {pstate.paths[k]: two_updates["agent"].tx.labels[k] for k in pstate.paths}
    init = _flat(two_updates["init"])
    want = {path: jpolicy._param_label(list(path)) for path in init}
    assert labels == want
    assert set(labels.values()) == {"main", "backbone", "frozen"}
    got = _flat(pstate.tree())
    jparams = _flat(two_updates["jstate"].params)
    moved = set()
    for path, label in labels.items():
        if label == "frozen":
            np.testing.assert_array_equal(got[path], init[path])
            np.testing.assert_array_equal(jparams[path], init[path])
        elif not np.array_equal(got[path], init[path]):
            moved.add(label)
    assert moved == {"main", "backbone"}


@pytest.mark.parametrize("group", ["main", "backbone"])
def test_adamw_state_per_group_matches_jax(two_updates, group):
    pstate = two_updates["pstate"]
    opt = pstate.opt_state[group]
    assert opt.count == 2
    names = {k: pstate.paths[k] for k in opt.mu}
    from genima_torch.weights.to_jax import params_tree

    noise = _gradient_free(two_updates["jstate"])
    for which in ("mu", "nu"):
        want = _jax_moments(two_updates["jstate"].opt_state, group, which)
        got = _flat(params_tree(getattr(opt, which), names))
        assert set(got) == set(want) and got
        scale = max(np.abs(w).max() for w in want.values())
        for path in noise & set(want):  # rounding noise: held to the group's scale
            assert np.abs(got[path]).max() <= 1e-6 * scale, (which, path)
        kept = sorted(set(want) - noise)
        if which == "nu":  # nu ~ g^2 doubles g's relative error: hold its root
            got, want = ({p: np.sqrt(t[p]) for p in kept} for t in (got, want))
        for path in kept:
            assert _rel(got[path], want[path]) <= 1e-3, (which, path)
        assert _rel(_cat(got, kept), _cat(want, kept)) <= REL, which


@pytest.mark.parametrize("clip", [None, 1.0])
def test_multi_transform_matches_optax(clip):
    """The chain on its own, two steps, against optax's: the frozen group's
    gradients are the largest here, so a clip that left them out of its
    norm would scale the others differently."""
    from genima_torch.core.optim import AdamW, MultiTransform

    rng = np.random.RandomState(13)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2), "f": (6,)}
    labels = {"a": "main", "b": "main", "c": "backbone", "f": "frozen"}
    params = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: (rng.randn(*v) * (30.0 if k == "f" else 0.5)).astype(np.float32)
              for k, v in shapes.items()} for _ in range(2)]
    chain = [optax.clip_by_global_norm(clip)] if clip else []
    tx = optax.chain(*chain, optax.multi_transform(
        {"main": optax.adamw(1e-2, weight_decay=1e-4), "backbone": optax.adamw(3e-3, weight_decay=1e-4),
         "frozen": optax.set_to_zero()}, labels))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    mt = MultiTransform({"main": AdamW(lambda _: 1e-2), "backbone": AdamW(lambda _: 3e-3)},
                        labels, clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = mt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts, norm = mt.step_(tp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts)
        if clip:
            want = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
            np.testing.assert_allclose(float(norm), want, rtol=1e-6)
            assert want > 10 * clip
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tp["f"].numpy(), params["f"])


def test_a_bf16_agent_trains_f32_master_weights():
    """Compute in bf16: the optimizer updates f32 copies, which the modules
    then take, rounded."""
    agent = policy.GenimaACTAgent(
        act_cfg=act.ACTConfig.tiny(num_queries=NQ), clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
        resnet_width=8, device="cpu", dtype=torch.bfloat16)
    state = agent.create_state(*agent.init_params(torch.Generator().manual_seed(0)))
    k = "actor.action_head.weight"
    assert state.master[k].dtype == torch.float32 and state.master[k] is not state.live[k]
    before = state.master[k].clone()
    g = torch.Generator().manual_seed(1)
    batch = _torch_batch(_batch(2))
    state, metrics = agent.update(state, batch, agent.sample_draws(batch, g))
    assert torch.isfinite(metrics["loss"]) and not torch.equal(state.master[k], before)
    for name, p in state.live.items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, state.master[name].to(torch.bfloat16)), name


# -- replay ----------------------------------------------------------------------------------


def test_replay_batches_match_jax():
    """Episodes of different lengths, frame stack 2: the same epoch batches
    over two epochs and the same ``sample()``."""
    rng = np.random.RandomState(12)
    kw = dict(batch_size=5, action_sequence=4, frame_stack=2, nstep=2, seed=3)
    j, p = JaxReplay(**kw), EpochReplayBuffer(**kw)
    for t in (7, 11, 4):
        ep = dict(images=rng.randint(0, 255, (t, 2, 6, 6, 3), np.uint8),
                  low_dim_state=rng.randn(t, 5).astype(np.float32),
                  actions=rng.randn(t, 3).astype(np.float32),
                  lang_tokens=rng.randint(0, 99, 77).astype(np.int32))
        j.add_episode(**ep)
        p.add_episode(**ep)
    assert len(j) == len(p) == 22
    for _ in range(2):
        jb, pb = list(j), list(p)
        assert len(jb) == len(pb) == 5
        for a, b in zip(jb, pb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = j.sample(), p.sample()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["images"].shape == (5, 4, 6, 6, 3)
