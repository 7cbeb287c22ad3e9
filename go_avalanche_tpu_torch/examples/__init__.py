"""The protocol studies of `examples/` on the port, one twin per script.

Each twin keeps its script's file name, public functions, signatures and
result dicts, imports `torch`, `numpy` and the port only, and runs as
``python -m go_avalanche_tpu_torch.examples.<study>`` on the card, or
with ``--device cpu`` on the CPU (there is no silent fallback: without
a card the default device raises).  A twin writes its artifact under
``go_avalanche_tpu_torch/examples/out/`` (never into ``examples/out/``,
which holds the JAX package's recorded artifacts); ``backend`` is the
torch device type, and every time or rate it reports stands beside the
card's name and power limit (``card``; None on the CPU).

  twin (this package)        JAX script
  -------------------------  ---------------------------------
  equivocation_threshold     examples/equivocation_threshold.py
  quorum_dial                examples/quorum_dial.py
  oppose_scaling             examples/oppose_scaling.py
  churn_tolerance            examples/churn_tolerance.py
  retire_cap_tradeoff        examples/retire_cap_tradeoff.py
  adversary_atlas            examples/adversary_atlas.py
  finality_curves            examples/finality_curves.py
  basic_preconsensus         examples/basic_preconsensus.py
  family_curves              examples/family_curves.py
  window_scaling             examples/window_scaling.py
  capacity_planning          examples/capacity_planning.py
  fault_scenarios            examples/fault_scenarios.py
  committee_scaling          examples/committee_scaling.py

The first seven record artifacts in ``examples/out/`` (``finality_curves``
writes ``finality_fit.json`` with ``--json-out``); those artifacts are
PRNG-exact, so a twin run at their recorded shape reproduces them, and
that is the gate ``chip_smoke.py`` holds the card to.  The scripts'
jax-free helpers (the fits, the churn models, ``c_q`` / ``a50``, the
atlas's ``monotonicity_report``) are copied verbatim, not imported.
Where a script fixes its sweep grid, the twin adds a flag whose default
is that grid, so a short run can cut it.
"""
