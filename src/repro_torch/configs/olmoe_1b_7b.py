"""olmoe-1b-7b [moe]: 64 experts top-8, MHA [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=10000.0,
    max_seq_len=32768,
    moe=MoESettings(num_experts=64, top_k=8, group_size=1024),
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=64, vocab_size=512,
                         max_seq_len=256, attention_chunk=64,
                         moe=MoESettings(num_experts=8, top_k=2,
                                         group_size=64))

SKIP_CELLS = {
    "long_500k": "pure full-attention arch: no sub-quadratic mechanism",
}
