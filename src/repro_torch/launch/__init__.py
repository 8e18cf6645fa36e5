"""repro_torch.launch: the launchers (counterpart of ``repro.launch``).

    steps.py   make_train_step / make_prefill_step / make_serve_step (LM)
               and make_cpals_step
    train.py   train (LM training: checkpoints, resume, the straggler
               monitor, gradient compression) and the ``python -m
               repro_torch.launch.train`` entry point
    serve.py   serve / generate (LM token serving, every arch),
               cpd_config / serve_cpd
               (decomposition serving through Session) and the
               ``python -m repro_torch.launch.serve`` entry point
    mesh.py    make_production_mesh, the logical-axis rules (BASE_RULES,
               rules_for, spec_for), sharding_fn / batch_sharding as DTensor
               placements, place (distribute a tree) and the activation
               hook (install)
    dryrun.py  the dry-run: one step of every (arch x shape x mesh) cell
               and each cpals workload's iteration traced on a fake
               256/512-rank group, on meta DTensors, into the H100
               roofline (``python -m repro_torch.launch.dryrun``)
"""
from .mesh import make_production_mesh, rules_for, sharding_fn

__all__ = ["make_production_mesh", "rules_for", "sharding_fn"]
