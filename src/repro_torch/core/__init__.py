"""Control plane (Amber), Reshape and Maestro objectives, and Reshape's
pipelined-execution simulator (``helpers``, ``transfer``, ``worker``,
``state_migration``, ``strategies``: Reshape and its baselines on the
dissertation's simulated operator): copies of the JAX-free ``repro.core``
modules."""
