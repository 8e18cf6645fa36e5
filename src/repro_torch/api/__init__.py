"""repro_torch.api: the single public API over the PyTorch decomposition
stack (counterpart of ``repro.api``).

    config.py    RunConfig = DataConfig + PlanConfig + MethodConfig +
                 ExecConfig + ObsConfig + ServeConfig: frozen, validated,
                 JSON-round-trippable, the JAX package's schema
    executor.py  ExecutorSpec registry (local / dist / streaming) + the one
                 method-capability gate (require_capability)
    session.py   Session(cfg, device=...) -> .ingest() -> .plan() -> .fit()
                 -> .serve_handle(), lazy cached stages, checkpoint resume;
                 run(cfg) one-shot
    cli.py       python -m repro_torch {ingest,plan,fit,serve,trace,metrics}
                 and the --list-methods / --list-impls capability matrices
"""
from .config import (ConfigError, DataConfig, ExecConfig, MethodConfig,
                     ObsConfig, PlanConfig, RunConfig, ServeConfig)
from .executor import (EXECUTORS, ExecutorSpec, executor_matrix, get_executor,
                       register_executor, require_capability)
from .session import ServeHandle, Session, run

__all__ = [
    "ConfigError", "DataConfig", "PlanConfig", "MethodConfig", "ExecConfig",
    "ObsConfig", "ServeConfig", "RunConfig",
    "EXECUTORS", "ExecutorSpec", "executor_matrix", "get_executor",
    "register_executor", "require_capability",
    "ServeHandle", "Session", "run",
]
