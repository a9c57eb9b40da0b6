"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865.  Encoder-decoder; conv frontend stubbed (input_specs() provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                 # decoder layers
    enc_layers=6,
    enc_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    layer_pattern=("dec",) * 6,
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
