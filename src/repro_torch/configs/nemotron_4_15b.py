"""nemotron-4-15b [dense]: GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    activation="relu2", norm="layernorm", pos_emb="rope", rope_theta=10000.0,
    max_seq_len=32768,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, attention_chunk=64)

SKIP_CELLS = {
    "long_500k": "pure full-attention arch: no sub-quadratic mechanism "
                 "(see DESIGN.md §Arch-applicability)",
}
