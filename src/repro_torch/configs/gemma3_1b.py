"""gemma3-1b [dense]: 26L, d_model=1152, 4H (GQA kv=1), d_ff=6912,
vocab=262144.  5:1 local:global attention (window 1024), 128k ctx (32k ctx for
1b), head_dim=256.  Sub-quadratic enough for long_500k: 22/26 layers keep a
bounded window-1024 cache; the 4 global layers hold a sequence-sharded cache.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

# 5 local : 1 global, repeating; 26 layers -> 4 full cycles + 2 local tail.
_PATTERN = (("local",) * 5 + ("attn",)) * 4 + ("local",) * 2

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    layer_pattern=_PATTERN,
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,   # 22/26 layers windowed; global layers seq-sharded
    source="hf:google/gemma-3-1b-pt",
)
