"""The port's fine-tune optimizers against the JAX package's, f32, on the CPU.

The same seeded params and gradients go through ``genima_tpu``'s optimizer
(optax, or its 8-bit AdamW) and the port's (``genima_torch/core/optim.py``).
Port tensors live in the port's layout (conv OIHW, dense (O, I)); the JAX
trees in the reference's (HWIO, (I, O)), and the 8-bit blocks run over the
reference's layout in both. Tolerances: params ``atol 1e-6`` (f32 rounding
of ~1e-3 updates); 8-bit codes equal, or one apart where the two divisions
round a tie apart; scales ``rtol 1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genima_tpu.core.optim import adamw_8bit as jax_adamw_8bit
from genima_tpu.diffusion import training as jax_training

from genima_torch.core import optim
from genima_torch.diffusion import training
from genima_torch.diffusion.train_state import layout_perms
from genima_torch.weights.to_jax import flax_layout, nest

PARAM_ATOL = 1e-6
SCALE_RTOL = 1e-6
# port name -> (flax path, port shape): over 4096 and a multiple of 256, over
# and not a multiple, under 4096 (f32 moments), conv and dense kernels
SHAPES = {
    "conv.weight": (("conv", "kernel"), (33, 16, 3, 3)),  # 4752 elements
    "dense.weight": (("dense", "kernel"), (70, 100)),  # 7000
    "big.bias": (("big", "bias"), (4096,)),
    "small.weight": (("small", "kernel"), (3, 3, 3, 3)),  # 81: f32 moments
    "norm.bias": (("norm", "bias"), (50,)),
}
PATHS = {k: p for k, (p, _) in SHAPES.items()}
LR_CFG = dict(learning_rate=1e-3, lr_scheduler="linear", lr_warmup_steps=0, max_train_steps=10)


def _port_params(seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, (_, s) in SHAPES.items()}


def _grads(seed, n):
    rng = np.random.RandomState(seed)
    return [{k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
             for k, (_, s) in SHAPES.items()} for _ in range(n)]


def _tree(tensors):
    """The reference's tree of port tensors (numpy, reference layout)."""
    return nest({PATHS[k]: np.ascontiguousarray(flax_layout(t, PATHS[k][-1]).numpy())
                 for k, t in tensors.items()})


def _leaf(tree, path):
    for token in path:
        tree = tree[token]
    return tree


def _assert_params(got, want, step):
    for k, t in got.items():
        np.testing.assert_allclose(flax_layout(t, PATHS[k][-1]).numpy(),
                                   np.asarray(_leaf(want, PATHS[k])), atol=PARAM_ATOL,
                                   err_msg=f"{k} after update {step}")


def _schedules():
    return (training.make_lr_schedule(training.TrainConfig(**LR_CFG)),
            jax_training.make_lr_schedule(jax_training.TrainConfig(**LR_CFG)))


def test_adamw_8bit_matches_jax():
    params = _port_params(0)
    sched, jsched = _schedules()
    opt = optim.AdamW8bit(sched, weight_decay=1e-2, perms=layout_perms(params, PATHS))
    tx = jax_adamw_8bit(jsched, weight_decay=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    js = tx.init(jp)
    state = opt.init(params)
    quantized = 0
    for i, g in enumerate(_grads(1, 3)):
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(g)), js, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.step_(params, g, state)
        assert state.count == int(js.count) == i + 1
        _assert_params(params, jp, i + 1)
        for got_m, want_m in ((state.mu, js.mu), (state.nu, js.nu)):
            for k, m in got_m.items():
                ref = _leaf(want_m, PATHS[k])
                if ref.full is not None:
                    assert m.q is None
                    np.testing.assert_allclose(m.full.numpy(), np.asarray(ref.full),
                                               rtol=1e-5, atol=1e-9, err_msg=k)
                    continue
                quantized += 1
                np.testing.assert_allclose(m.scale.numpy(), np.asarray(ref.scale),
                                           rtol=SCALE_RTOL, err_msg=k)
                dq = m.q.numpy().astype(np.int32) - np.asarray(ref.q).astype(np.int32)
                assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-3, k
    assert quantized == 2 * 3 * 3  # conv, dense and big.bias quantised, both moments


def test_optimizer_state_bytes():
    params = _port_params(0)
    sched, _ = _schedules()
    n = sum(t.numel() for t in params.values())
    f32 = optim.AdamW(sched).init(params)
    assert optim.optimizer_state_bytes(f32) == 8 * n
    q8 = optim.AdamW8bit(sched, perms=layout_perms(params, PATHS)).init(params)
    blocks = sum(-(-t.numel() // optim.BLOCK) for t in params.values()
                 if t.numel() >= optim.MIN_QUANTIZED)
    small = sum(t.numel() for t in params.values() if t.numel() < optim.MIN_QUANTIZED)
    assert optim.optimizer_state_bytes(q8) == 2 * (blocks * optim.BLOCK + 4 * blocks + 4 * small)


def test_adam_mu_bf16_matches_optax():
    """optax ``adamw(mu_dtype=bfloat16)``: b1 mu in bf16, the rest in f32."""
    params = _port_params(2)
    sched, jsched = _schedules()
    opt = optim.AdamW(sched, weight_decay=1e-2, mu_dtype=torch.bfloat16)
    tx = optax.adamw(jsched, 0.9, 0.999, 1e-8, weight_decay=1e-2, mu_dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    js = tx.init(jp)
    state = opt.init(params)
    for i, g in enumerate(_grads(3, 3)):
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(g)), js, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.step_(params, g, state)
        _assert_params(params, jp, i + 1)
        for k, m in state.mu.items():
            assert m.dtype == torch.bfloat16
            want = np.asarray(_leaf(js[0].mu, PATHS[k]), np.float32)
            np.testing.assert_array_equal(flax_layout(m, PATHS[k][-1]).float().numpy(), want,
                                          err_msg=k)


@pytest.mark.parametrize("inner", ["adamw", "adamw_8bit"])
def test_gradient_accumulation_matches_multisteps(inner):
    """optax.MultiSteps(chain(clip, adam), k=2) over 4 mini-steps: the clip
    and the update run on the mean every second mini-step, and the params
    stay bit-unchanged in between."""
    params = _port_params(4)
    sched, jsched = _schedules()
    if inner == "adamw":
        adam, jadam = optim.AdamW(sched, weight_decay=1e-2), optax.adamw(jsched, weight_decay=1e-2)
    else:
        adam = optim.AdamW8bit(sched, weight_decay=1e-2, perms=layout_perms(params, PATHS))
        jadam = jax_adamw_8bit(jsched, weight_decay=1e-2)
    opt = optim.MultiSteps(optim.Clipped(adam, 0.5), 2)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5), jadam), 2)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(params))
    js = tx.init(jp)
    state = opt.init(params)
    for i, g in enumerate(_grads(5, 4)):
        before = {k: t.clone() for k, t in params.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(g)), js, jp)
        jp = optax.apply_updates(jp, upd)
        state, norm = opt.step_(params, g, state)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(_tree(g))), rtol=1e-6)
        assert (state.mini_step, state.gradient_step) == (int(js.mini_step), int(js.gradient_step))
        assert state.inner_opt_state.count == (i + 1) // 2
        _assert_params(params, jp, i + 1)
        unchanged = all(torch.equal(before[k], t) for k, t in params.items())
        assert unchanged == (i % 2 == 0), f"mini-step {i + 1}"
        for k, acc in state.acc_grads.items():
            np.testing.assert_allclose(flax_layout(acc, PATHS[k][-1]).numpy(),
                                       np.asarray(_leaf(js.acc_grads, PATHS[k])), atol=1e-7)
