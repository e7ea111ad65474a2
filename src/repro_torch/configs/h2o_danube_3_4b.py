"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window
attention (the reference's full-width SWA model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=10000.0,
    max_seq_len=32768, sliding_window=4096,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, sliding_window=64,
                         attention_chunk=32)

# The ring-window cache keeps decode memory bounded by the window.
SKIP_CELLS = {}
