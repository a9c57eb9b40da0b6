"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` is the command; this package is what it runs: the files
of a cell found by name (``spec``), the traffic generator (``traffic``
over the frozen ``samplers``), the weights drawn from the seed
(``weights``), the client that drives the serve engine and times it
(``drive``), the device trace's reading (``trace``), the output check
(``check``) and the frozen arithmetic (``yardstick``).  Nothing here
imports JAX or the JAX package.
"""
