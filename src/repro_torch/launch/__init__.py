"""repro_torch.launch: the launchers (counterpart of ``repro.launch``).

    steps.py   make_prefill_step / make_serve_step (LM) and make_cpals_step
    serve.py   serve / generate (LM token serving, every arch),
               cpd_config / serve_cpd
               (decomposition serving through Session) and the
               ``python -m repro_torch.launch.serve`` entry point

The production mesh (``mesh.py``), training (``train.py``) and the dry-run
are not ported yet (ROADMAP §1 items 10b-2, 10b-3, 10c).
"""
