"""llama3.2-3b [dense]: small llama3, GQA, tied embeddings [hf:meta-llama]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=500000.0,
    max_seq_len=131072, tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, attention_chunk=64)

SKIP_CELLS = {
    "long_500k": "pure full-attention arch: no sub-quadratic mechanism",
}
