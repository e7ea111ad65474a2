"""Tiny test config (CI/examples)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tiny", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=10000.0,
    max_seq_len=512, attention_chunk=64,
)
REDUCED = CONFIG
SKIP_CELLS = {}
