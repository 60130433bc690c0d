"""The harness: the files of ``BENCHMARK.json`` found by name (``spec``),
the deployment drawn from the seed (``inputs``), the system under test
(``port``), the closed loop and its statistics (``window``), the traced
run's record (``trace``) and the judgement of the window's proofs
(``check``)."""
