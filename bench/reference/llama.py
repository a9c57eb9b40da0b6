"""Plain float32 reference of a Llama-style decoder, the Yi family's block
(arXiv:2403.04652, section 2.2: "a modified version of the decoder-only
Transformer architecture" of LLaMA, with grouped-query attention, SwiGLU
and RMSNorm; rotary positions at base ``rope_theta``).

Per layer: h = x + Attn(RMSNorm(x)); x' = h + SwiGLU(RMSNorm(h)); then a
final RMSNorm and the untied output head.  No biases.
"""
from __future__ import annotations

import torch

from reference._plain import attention, rms_norm, swiglu


def _dims(c):
    d, nh = c["hidden_size"], c["num_attention_heads"]
    hd = c.get("head_dim") or d // nh
    return d, nh, c["num_key_value_heads"], hd


def layout(c):
    """The weights: the embedding, ``num_hidden_layers`` stacked blocks
    under ``attn`` (``x @ w`` for every product), the final norm, the
    head."""
    d, nh, nkv, hd = _dims(c)
    n, f, v = c["num_hidden_layers"], c["intermediate_size"], \
        c["vocab_size"]
    return {"embed": ((v, d), "embed"), "final_ln": ((d,), "gain"),
            "lm_head": ((d, v), "normal"),
            "attn": {"ln1": ((n, d), "gain"), "ln2": ((n, d), "gain"),
                     "wq": ((n, d, nh * hd), "normal"),
                     "wk": ((n, d, nkv * hd), "normal"),
                     "wv": ((n, d, nkv * hd), "normal"),
                     "wo": ((n, nh * hd, d), "normal"),
                     "w_gate": ((n, d, f), "normal"),
                     "w_up": ((n, d, f), "normal"),
                     "w_down": ((n, f, d), "normal")}}


def block(w, x, c, mm):
    eps = float(c["rms_norm_eps"])
    h = x + attention(rms_norm(x, w["ln1"], eps), w, c, mm)
    return h + swiglu(rms_norm(h, w["ln2"], eps), w["w_gate"], w["w_up"],
                      w["w_down"], mm)


def head(weights, xs, starts, c, mm):
    """Final norm and head over each sequence's rows from its start."""
    g = weights["final_ln"].float()
    head_w = weights["lm_head"].float()
    eps = float(c["rms_norm_eps"])
    return [mm(rms_norm(x[s:], g, eps), head_w) for x, s in zip(xs, starts)]


def logits(weights, seqs, starts, c, mm):
    """Logits [len(seq) - start, vocab] of each sequence, layer by layer."""
    xs = [weights["embed"][torch.as_tensor(s, dtype=torch.long,
                                           device=weights["embed"].device)]
          .float() for s in seqs]
    for li in range(c["num_hidden_layers"]):
        w = {k: v[li].float() for k, v in weights["attn"].items()}
        xs = [block(w, x, c, mm) for x in xs]
        del w
    return head(weights, xs, starts, c, mm)
