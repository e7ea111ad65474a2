"""mixtral-8x22b [moe]: 8 experts top-2, SWA [arXiv:2401.04088].  Its
full size needs several cards; the port runs it at ``REDUCED`` size."""
from repro_torch.configs.base import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=1000000.0,
    max_seq_len=65536, sliding_window=4096,
    moe=MoESettings(num_experts=8, top_k=2, group_size=2048),
    optimizer="adafactor",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, sliding_window=64,
                         attention_chunk=32,
                         moe=MoESettings(num_experts=4, top_k=2,
                                         group_size=64),
                         optimizer="adamw")

SKIP_CELLS = {}  # SWA ring buffer -> long_500k runnable
