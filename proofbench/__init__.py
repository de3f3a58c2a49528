"""The benchmark of otti_tpu_torch: zero-knowledge proofs of LP optimality
certificates served from a pool of lowered instances on the card.

``python3 -m proofbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Configurations,
traffic mixes and per-layer metrics are files under ``configs/``,
``traffic/`` and ``layer_metrics/``, found by their names; ``reference/``
holds the plain lowering and verifier that decide ``correct``.
"""
