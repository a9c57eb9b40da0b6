"""A configuration file as the program runs it.

The file's model keys carry the Hugging Face names of the model's
``config.json`` (``hidden_size``, ``num_key_value_heads``, ...).
"""
from __future__ import annotations

from typing import Dict

# configuration key -> ArchConfig field
_FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads",
           "intermediate_size": "d_ff", "vocab_size": "vocab",
           "head_dim": "head_dim", "rope_theta": "rope_theta",
           "rms_norm_eps": "norm_eps",
           "tie_word_embeddings": "tie_embeddings"}


def arch_config(c: Dict):
    """The program's dense ``ArchConfig`` of configuration file ``c``."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name=c["name"], family="dense",
                      source=c.get("source", ""),
                      **{f: c[k] for k, f in _FIELDS.items() if k in c})


def check_layout(arch, weights_shapes: Dict) -> None:
    """Raise unless the program's parameter tree (``lm.abstract``, on the
    meta device) has the reference layout's names and shapes."""
    from repro_torch.models import lm

    def walk(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)
    prog = dict(walk(lm.abstract(arch)))
    if prog != weights_shapes:
        diff = sorted(set(prog.items()) ^ set(weights_shapes.items()))
        raise ValueError(f"the program's weights differ from the "
                         f"reference layout: {diff[:6]}")
