"""The env factory dispatch.

Counterpart of ``genima_tpu/envs/rlbench.py::make_factory`` for the fake
env only: the RLBench simulator (CoppeliaSim / PyRep) and the rendered-demo
factory are not driven by the port, and asking for them raises.
"""

from __future__ import annotations


def _train_tasks(env_cfg: dict) -> list[str]:
    """``env.train_tasks`` (a list or a comma-separated string), else the
    single ``env.task``."""
    tasks = env_cfg.get("train_tasks")
    if tasks:
        if isinstance(tasks, str):
            tasks = [t.strip() for t in tasks.split(",") if t.strip()]
        return list(tasks)
    return [env_cfg.get("task", "fake_reach")]


def make_factory(env_cfg: dict):
    """``env.factory: fake`` -> ``FakeRLBenchFactory``; any other factory
    raises, naming what is missing."""
    kind = env_cfg.get("factory", "rlbench")
    if kind != "fake":
        raise NotImplementedError(
            f"env.factory={kind!r} needs the RLBench simulator (CoppeliaSim, PyRep) or "
            "the rendered-demo factory, which the port does not drive yet; use "
            "env.factory=fake")
    from genima_torch.envs.fake import FakeRLBenchFactory

    tasks = _train_tasks(env_cfg)
    return FakeRLBenchFactory(
        task_names=tasks,
        task_name=tasks[0],
        episode_length=env_cfg.get("episode_length", 60),
        image_size=env_cfg.get("image_size", 64),
        goal_observable=env_cfg.get("goal_observable", False),
        success_tol=env_cfg.get("success_tol", 0.1),
    )
