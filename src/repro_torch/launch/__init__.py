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

The production mesh (``mesh.py``) and the dry-run are not ported yet
(ROADMAP §1 items 10b-3, 10c).
"""
