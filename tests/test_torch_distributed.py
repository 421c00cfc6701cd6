"""The port's one-writer guards and per-process striding against the JAX
package's (``tests/test_distributed.py``'s cases through both packages):
the process helpers, ``force_process``, ``initialize`` without a topology,
a non-main ``MetricLogger`` and the checkpoint writers (the async one
included) writing nothing, ``shard_samples``, and the diffusion loader's
and the replay buffer's per-process orders under ``force_process(i, 2)``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from genima_tpu.control.replay import EpochReplayBuffer as JaxReplay
from genima_tpu.core import checkpoint as jax_ckpt
from genima_tpu.core import distributed as jax_dist
from genima_tpu.core.logging import MetricLogger as JaxLogger
from genima_tpu.data.dataset import DiffusionDataLoader as JaxLoader
from genima_tpu.data.dataset import Sample as JaxSample
from genima_tpu.data.tokenizer import HashTokenizer as JaxTokenizer

from genima_torch.control.replay import EpochReplayBuffer
from genima_torch.core import checkpoint as ckpt
from genima_torch.core import distributed as dist
from genima_torch.core.logging import MetricLogger
from genima_torch.core.mesh import make_mesh, shard_batch
from genima_torch.data.dataset import DiffusionDataLoader, Sample
from genima_torch.data.tokenizer import HashTokenizer

PACKAGES = {"port": (dist, ckpt, MetricLogger), "jax": (jax_dist, jax_ckpt, JaxLogger)}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_process_helpers_default_single(pkg):
    d = PACKAGES[pkg][0]
    assert (d.process_index(), d.process_count(), d.is_main_process()) == (0, 1, True)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_force_process_restores(pkg):
    d = PACKAGES[pkg][0]
    with d.force_process(3, 8):
        assert (d.process_index(), d.process_count(), d.is_main_process()) == (3, 8, False)
    assert d.is_main_process()


def test_initialize_is_a_noop_without_a_topology(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False and jax_dist.initialize() is False
    assert not dist.group_active() and dist.process_count() == 1
    monkeypatch.setenv("LOCAL_RANK", "1")  # a launcher's device hint alone starts nothing
    assert dist.initialize(device="cpu") is False
    assert dist.process_device("cuda") == torch.device("cuda", 1)
    assert dist.process_device("cuda:0") == torch.device("cuda", 0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_metric_logger_non_main_writes_nothing(pkg, tmp_path):
    d, _, logger_cls = PACKAGES[pkg]
    with d.force_process(2, 4):
        logger = logger_cls(tmp_path / "logs")
        logger.log_metrics({"loss": 0.5}, 1, echo=False)
        logger.log_images({"img": np.zeros((4, 4, 3), np.uint8)}, 1)
        logger.close()
    assert not (tmp_path / "logs" / "metrics.jsonl").exists()
    logger = logger_cls(tmp_path / "logs")
    logger.log_metrics({"loss": 0.5}, 1, echo=False)
    logger.close()
    assert (tmp_path / "logs" / "metrics.jsonl").exists()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_checkpoint_writers_guarded(pkg, tmp_path):
    d, c, _ = PACKAGES[pkg]
    params = {"w": np.arange(3, dtype=np.float32)}
    with d.force_process(1, 2):
        p1 = c.save_epoch_checkpoint(tmp_path / "ctrl", epoch=1, num_iters=5,
                                     agent_params=params)
        p2 = c.save_step_checkpoint(tmp_path / "diff", 10, model_params=params)
        p3 = c.save_final_model(tmp_path / "final", params, "controlnet")
    assert (p1.name, p2.name, p3.name) == ("latest.ckpt", "checkpoint-10", "controlnet")
    assert not p1.exists() and not p2.exists() and not p3.exists()
    assert c.save_epoch_checkpoint(tmp_path / "ctrl", epoch=1, num_iters=5,
                                   agent_params=params).exists()


def test_async_writer_takes_no_copy_on_a_non_main_rank(tmp_path):
    writer = ckpt.AsyncCheckpointer()
    with dist.force_process(1, 2):
        writer.submit(ckpt.save_step_checkpoint, tmp_path, 3,
                      model_params={"w": torch.ones(4)})
    assert writer._pending is None and writer._device_arena is None
    writer.submit(ckpt.save_step_checkpoint, tmp_path, 3, model_params={"w": torch.ones(4)})
    writer.close()
    assert (tmp_path / "checkpoint-3" / "controlnet" / "params.msgpack").is_file()


@pytest.mark.parametrize("n,count", [(11, 4), (8, 2), (3, 5)])
def test_shard_samples_partition_equals_jax(n, count):
    samples = list(range(n))
    shards = [dist.shard_samples(samples, i, count) for i in range(count)]
    assert shards == [jax_dist.shard_samples(samples, i, count) for i in range(count)]
    assert sorted(s for sh in shards for s in sh) == samples
    assert dist.shard_samples(samples) == samples


def _fill(buf, seed=0):
    rng = np.random.RandomState(seed)
    for T in (7, 5):
        buf.add_episode(images=rng.randint(0, 255, (T, 1, 4, 4, 3)).astype(np.uint8),
                        low_dim_state=rng.randn(T, 8).astype(np.float32),
                        actions=rng.randn(T, 8).astype(np.float32))


@pytest.mark.parametrize("rank", [0, 1])
def test_replay_per_process_order_equals_jax(rank):
    port, ref = EpochReplayBuffer(3, 4, seed=7), JaxReplay(3, 4, seed=7)
    _fill(port), _fill(ref)
    for _ in range(2):  # two epochs: the shared permutation advances alike
        with dist.force_process(rank, 2), jax_dist.force_process(rank, 2):
            got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for k in ("qpos", "actions", "images", "is_pad"):
                np.testing.assert_array_equal(a[k], b[k])


def test_replay_drop_last_pairs_the_ranks():
    """drop_last (data-parallel) caps every rank at the smallest slice's
    batches, so the ranks' updates pair up."""
    counts = []
    for rank in range(2):
        buf = EpochReplayBuffer(batch_size=2, action_sequence=4, seed=7, drop_last=True)
        _fill(buf)  # 12 samples: 6 a rank
        with dist.force_process(rank, 2):
            counts.append([len(b["qpos"]) for b in buf])
    assert counts == [[2, 2, 2], [2, 2, 2]]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(9):
        p = root / f"{i}.png"
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("rank", [0, 1])
def test_diffusion_loader_per_process_order_equals_jax(samples, rank):
    port = DiffusionDataLoader([Sample(p, p, f"t{i}") for i, p in enumerate(samples)],
                               HashTokenizer(), batch_size=2, resolution=8, seed=3,
                               num_workers=1, use_native=False)
    ref = JaxLoader([JaxSample(p, p, f"t{i}") for i, p in enumerate(samples)], JaxTokenizer(),
                    batch_size=2, resolution=8, seed=3, num_workers=1, use_native=False)
    with dist.force_process(rank, 2), jax_dist.force_process(rank, 2):
        got, want = list(port), list(ref)
        assert len(port) == 2
    # 9 samples: slices of 5 and 4; both ranks take 2 batches (4 rows)
    assert len(got) == 2 and len(want) >= 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["pixel_values"], b["pixel_values"], atol=1e-6)
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_shard_batch_on_one_process_places_the_batch():
    batch = {"x": np.arange(16, dtype=np.float32).reshape(16, 1)}
    (out,) = shard_batch(batch, make_mesh(n_data=1, devices=["cpu"]))
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"])
    halves = shard_batch(batch, make_mesh(n_data=2, devices=["cpu", "cpu"]))
    assert [h["x"][0, 0].item() for h in halves] == [0.0, 8.0]


DISTRIBUTION_PATH = """
import importlib, sys
for name in ("core.distributed", "core.mesh", "core.tp", "cfgs", "cli.convert_checkpoint",
             "weights.goldens", "weights.load_pretrained", "eval.parallel", "cli.train_act",
             "diffusion.driver"):
    importlib.import_module("genima_torch." + name)
absent = ("jax", "jaxlib", "genima_tpu", "flax", "msgpack", "yaml", "safetensors")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
assert not bad, bad
"""


def test_distribution_and_conversion_paths_import_none_of_the_packages_the_card_lacks():
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", DISTRIBUTION_PATH], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
