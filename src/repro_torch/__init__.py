"""PyTorch/CUDA port of the ``repro`` runtime.

The package mirrors ``src/repro``'s layout module for module, imports only
torch, numpy, the standard library (and networkx, through the copied
control-plane modules) and itself, and runs its hand-written kernels on an
NVIDIA Hopper card.  Each kernel keeps a plain torch version beside it,
which is what a CPU tensor gets.
"""
