"""Paper config: LLaMA 1B (Table 4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-1b", family="dense",
    n_layers=48, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=3392, vocab_size=32000,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=10000.0,
    max_seq_len=2048,
)
REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256)
SKIP_CELLS = {}
