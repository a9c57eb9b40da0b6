"""Plain references, one module per model family (``<family>.py``).

Each module is plain PyTorch in float32, written from its paper's
description and from the configuration file's keys (Hugging Face names),
and imports nothing of the program (``repro_torch``), of JAX or of the
JAX package.  It gives:

* ``layout(cfg)``: the weights both sides read, by name, with their
  shapes and the law ``weights.draw`` fills them by;
* ``logits(weights, seqs, starts, cfg, mm)``: for each token sequence,
  the logits of its positions from ``starts[i]`` on, computed layer by
  layer (one layer's weights in float32 at a time, so that the largest
  model fits beside its bfloat16 weights); ``mm`` is the matrix product
  (``f32_mm``, or a lower precision's for the control).
"""
