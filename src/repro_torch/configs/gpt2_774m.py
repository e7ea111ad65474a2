"""Paper config: GPT-2 774M (Table 4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-774m", family="dense",
    n_layers=36, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=50257,
    activation="gelu", norm="layernorm", pos_emb="learned",
    max_seq_len=1024, tie_embeddings=True,
)
REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256)
SKIP_CELLS = {}
