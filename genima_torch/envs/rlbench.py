"""The env factory dispatch.

Counterpart of ``genima_tpu/envs/rlbench.py::make_factory`` for the fake
env and the rendered-demo factory (demos from an on-disk dataset tree,
closed-loop envs from ``env.eval_env_factory``). The RLBench simulator
(CoppeliaSim / PyRep) is not driven by the port: asking for it meets the
gate JAX meets without RLBench installed and raises ``SimulatorMissing``
(an ``ImportError``, as JAX's gate raises). With ``env.colosseum_use`` the
factory takes ``env.colosseum_task_config`` (a Colosseum config: a YAML
path, or a name of ``cfgs.COLOSSEUM``), as JAX's does, before the gate.
"""

from __future__ import annotations

CAMERAS = ("wrist", "front", "right_shoulder", "left_shoulder")


class SimulatorMissing(ImportError, NotImplementedError):
    """The RLBench simulator is not there: JAX's gate raises ImportError."""


def _require_rlbench(colosseum_task_config=None):
    extra = (f" (Colosseum config {colosseum_task_config!r} needs it too)"
             if colosseum_task_config else "")
    raise SimulatorMissing(
        "rlbench/pyrep are not installed; install CoppeliaSim + PyRep + RLBench or use "
        "env.factory=fake. The port does not drive the RLBench simulator (CoppeliaSim, "
        "PyRep): use env.factory=fake, or env.factory=rendered with env.dataset_root and "
        f"env.eval_env_factory=fake{extra}")


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
    """``env.factory: fake`` -> ``FakeRLBenchFactory``; ``rendered`` ->
    ``RenderedDemoFactory`` over ``env.dataset_root``, its eval envs from
    the factory ``env.eval_env_factory`` names; any other factory raises,
    naming what is missing (``SimulatorMissing``)."""
    kind = env_cfg.get("factory", "rlbench")
    tasks = _train_tasks(env_cfg)
    if kind == "fake":
        from genima_torch.envs.fake import FakeRLBenchFactory

        return FakeRLBenchFactory(
            task_names=tasks,
            task_name=tasks[0],
            episode_length=env_cfg.get("episode_length", 60),
            image_size=env_cfg.get("image_size", 64),
            goal_observable=env_cfg.get("goal_observable", False),
            success_tol=env_cfg.get("success_tol", 0.1),
        )
    if kind == "rendered":
        # demos from an on-disk (rendered) dataset tree, the reference's
        # train-act flow (env.dataset_root points at rendered data,
        # controller/env/rlbench.py:301-383)
        from genima_torch.envs.rendered import RenderedDemoFactory

        inner_kind = env_cfg.get("eval_env_factory")
        eval_factory = None
        if inner_kind:
            eval_factory = make_factory({**env_cfg, "factory": inner_kind})
        return RenderedDemoFactory(
            dataset_root=env_cfg["dataset_root"],
            task_names=tasks,
            variation=env_cfg.get("variation", 0),
            cameras=tuple(env_cfg.get("cameras", CAMERAS)),
            eval_factory=eval_factory,
        )
    colosseum_task_config = (env_cfg.get("colosseum_task_config")
                             if env_cfg.get("colosseum_use") else None)
    _require_rlbench(colosseum_task_config)
