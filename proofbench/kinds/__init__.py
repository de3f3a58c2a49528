"""Certificate kinds, one file a kind: a configuration's ``kind`` names
``kinds/<kind>.py``, which cell.load loads by its path.  A kind file gives

- ``KEYS``: the configuration keys it reads;
- ``program(config, seed, index, tmpdir) -> (R1CSShape, vars, inputs)``:
  instance ``index`` of the run made from the seed and lowered by the
  program's own lowering (the program imported inside the body alone);
- ``reference(config, seed, index)``: the same instance, lowered by the
  plain reference under ``reference/``, importing nothing of the program: an
  R1CS with ``num_cons``, ``num_vars``, ``num_inputs``, ``entries(m)`` and
  ``unsatisfied(witness, inputs)``, and what the route's verifier reads of
  it (``reference/lowering.R1CS`` has all of that).
"""
