"""starcoder2-7b [dense]: 32L, d_model=4608, 36H (GQA kv=4), d_ff=18432,
vocab=49152.  GQA, RoPE.  [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2402.19173",
)
