"""The port's serving mesh (``core/mesh.py``, ``core/tp.py``,
``eval/parallel.py``) against the JAX package's rules and its own
meshless path, on the CPU listed more than once.

- ``make_mesh``: the shapes and the error of JAX's ``make_mesh``.
- ``tp_param_shardings``: JAX's rule leaf by leaf on a tiny UNet tree (the
  suite's 8 virtual CPU devices give JAX its 2-device fsdp axis).
- ``shard_params_tp`` at fsdp=2: a tiny UNet + ControlNet forward equals the
  unsharded modules to 1e-5, in f32 and under ``+w8``; the originals stay
  as they were.
- ``BatchedGenimaStep`` over a 2x1 and a 1x2 mesh: the meshless step's
  actions and targets.
- ``eval_genima`` with ``eval_data_parallel=true eval_mesh_devices=2
  num_parallel_envs=2``, and with ``eval_tensor_parallel=2``: the meshless
  batched run's episodes.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from genima_tpu.core.mesh import make_mesh as jax_make_mesh
from genima_tpu.core.tp import tp_param_shardings as jax_tp_param_shardings

from genima_torch.cli import eval_genima
from genima_torch.control import policy
from genima_torch.core.mesh import make_mesh
from genima_torch.core.tp import ColumnSharded, shard_params_tp, tp_param_shardings
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import make_tiny_sd_agent
from genima_torch.eval.parallel import BatchedGenimaStep
from genima_torch.nn.act import ACTConfig
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig
from genima_torch.weights.to_jax import tree_from_module

from test_torch_parallel_eval import (  # noqa: F401  (the trained-controller fixture)
    CLI_ARGS, TINY_AGENT, _copy, _tiny_clip, trained,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_data,n_fsdp,n_dev", [(None, 1, 8), (None, 2, 8), (2, 2, 8),
                                                 (1, 2, 3)])
def test_make_mesh_shapes_equal_jax(n_data, n_fsdp, n_dev):
    import jax

    ours = make_mesh(n_data, n_fsdp, devices=[CPU] * n_dev)
    ref = jax_make_mesh(n_data, n_fsdp, devices=jax.devices()[:n_dev])
    assert ours.shape == dict(ref.shape) and ours.devices.shape == ref.devices.shape


def test_make_mesh_error_equals_jax():
    import jax

    with pytest.raises(ValueError) as ours:
        make_mesh(3, 2, devices=[CPU] * 4)
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(3, 2, devices=jax.devices()[:4])
    head = "make_mesh needs 6 devices for a 3x2 (data x fsdp) mesh but only 4 are available"
    assert str(ours.value).startswith(head) and str(ref.value).startswith(head)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, (*prefix, key)).items()}
    return {prefix: tree}


SYNTHETIC = {  # every branch of the rule, at sizes 2 and 3
    "embed": {"embedding": np.zeros((10, 6))}, "position_embedding": np.zeros((77, 6)),
    "conv": {"kernel": np.zeros((3, 3, 4, 6)), "bias": np.zeros(6)},
    "dense": {"kernel": np.zeros((4, 9)), "bias": np.zeros(9)},
    "norm": {"scale": np.zeros(5), "bias": np.zeros(5)},
    "other": {"weird": np.zeros((4, 6))},
}


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("tree", ["unet", "controlnet", "synthetic"])
def test_tp_rule_equals_jax_leaf_by_leaf(tree, size):
    if tree == "synthetic":
        tree = SYNTHETIC
    else:
        module = _pipe("xla").init_params(torch.Generator().manual_seed(0))[tree]
        tree = tree_from_module(module, f"diffusers_{tree}")
    ours = _flat(tp_param_shardings(tree, size))
    ref = _flat(jax_tp_param_shardings(tree, jax_make_mesh(1, size)))
    assert ours.keys() == ref.keys()
    for k in ours:
        assert PartitionSpec(*ours[k]) == ref[k].spec, k
    if tree is SYNTHETIC:
        assert any(ours.values()) and not all(ours.values())


def _pipe(backend):
    return SDControlNetPipeline(unet_cfg=UNetConfig.tiny(), vae_cfg=VAEConfig.tiny_test(),
                                text_cfg=CLIPTextConfig.tiny(), dtype=torch.float32,
                                device="cpu", backend=backend)


def _forward(models, inputs):
    sample, t, ctx, cond = inputs
    down, mid = models["controlnet"](sample, t, ctx, cond)
    eps = models["unet"](sample, t, ctx, down_block_additional_residuals=down,
                         mid_block_additional_residual=mid)
    return eps, mid


@pytest.mark.parametrize("backend", ["xla", "fused+w8"])
def test_tp_sharded_unet_and_controlnet_equal_the_whole_modules(backend):
    params = _pipe(backend).init_params(torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    inputs = (torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32)),
              torch.tensor([999.0, 17.0]),
              torch.from_numpy(rng.randn(2, 5, 32).astype(np.float32)),
              torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32)))
    before = {k: v.clone() for k, v in params["unet"].state_dict().items()}
    sharded = shard_params_tp({k: params[k] for k in ("unet", "controlnet")},
                              make_mesh(1, 2, devices=[CPU, CPU]))
    n_sharded = sum(isinstance(m, ColumnSharded) for m in sharded["unet"].modules())
    assert n_sharded > 10
    assert not any(isinstance(m, ColumnSharded) for m in params["unet"].modules())
    with torch.no_grad():
        want = _forward(params, inputs)
        got = _forward(sharded, inputs)
    for g, w in zip(got, want):
        assert (g - w).norm() <= 1e-5 * w.norm()
    after = params["unet"].state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def _controller():
    agent = policy.GenimaACTAgent(act_cfg=ACTConfig.tiny(num_queries=4),
                                  clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
                                  resnet_width=8, device="cpu", dtype=torch.float32)
    params, clip = agent.init_params(torch.Generator().manual_seed(2))
    return agent, params, clip


@pytest.mark.parametrize("n_data,n_fsdp", [(2, 1), (1, 2)])
def test_batched_step_over_a_mesh_equals_the_meshless_step(n_data, n_fsdp):
    dag = make_tiny_sd_agent(device="cpu", backend="xla")
    agent, params, clip = _controller()
    rng = np.random.RandomState(3)
    n = 2
    args = (torch.from_numpy(rng.randint(0, 255, (n, 64, 64, 3)).astype(np.uint8)),
            dag.embed_prompt_ids(np.zeros((n, 77), np.int32)),
            dag.draw_latents(n, torch.Generator().manual_seed(0)),
            torch.from_numpy(rng.randn(n, 8).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 1000, (n, 77)).astype(np.int32)))
    want = BatchedGenimaStep(dag, agent, 32)(dag.params, params, clip, *args,
                                             num_inference_steps=2)
    step = BatchedGenimaStep(dag, agent, 32, mesh=make_mesh(n_data, n_fsdp, [CPU, CPU]))
    try:
        got = step(dag.params, params, clip, *args, num_inference_steps=2)
        again = step(dag.params, params, clip, *args, num_inference_steps=2)
    finally:
        step.close()
    assert step._param_key[0] is dag.params  # placed once for these trees
    # a row at batch 1 against the whole at batch 2: the library's kernels may
    # round otherwise, and a target pixel on a .5 boundary then moves the tiny
    # controller's actions (test_torch_parallel_eval.py's ACTION_ATOL)
    torch.testing.assert_close(got[0], want[0].float(), rtol=0, atol=5e-4)
    assert (got[1].int() - want[1].int()).abs().max() <= 1
    torch.testing.assert_close(again[0], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("mesh_args", [["eval_data_parallel=true", "eval_mesh_devices=2"],
                                       ["eval_tensor_parallel=2", "eval_mesh_devices=2"]])
def test_eval_cli_over_a_mesh_gives_the_meshless_episodes(trained, tmp_path, monkeypatch,
                                                          mesh_args):
    _tiny_clip(monkeypatch)
    base = ["device=cpu", "num_parallel_envs=2"] + CLI_ARGS + TINY_AGENT
    plain = eval_genima.main([f"controller_ckpt={_copy(trained, tmp_path, 'plain')}"] + base)
    meshed = eval_genima.main([f"controller_ckpt={_copy(trained, tmp_path, 'mesh')}"] + base
                              + mesh_args)
    assert meshed["eval_episodes"] == plain["eval_episodes"]
    assert meshed["results"]["total_episodes"] == 3
    assert meshed["results"]["env_exception_episodes"] == 0
