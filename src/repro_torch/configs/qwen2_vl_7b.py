"""qwen2-vl-7b [vlm]: 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064.  M-RoPE (3-section rotary over t/h/w position ids), dynamic
resolution.  Transformer BACKBONE only; the vision patch-embedding frontend is
a stub — ``input_specs()`` provides precomputed patch embeddings and 3-D
position ids.  [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    mrope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2409.12191",
)
