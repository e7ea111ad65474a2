"""llama-3.2-vision-90b [vlm]: cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision scaled to 90B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    activation="swiglu", norm="rmsnorm", pos_emb="rope", rope_theta=500000.0,
    max_seq_len=131072, cross_attn_period=5, n_patches=1601,
    optimizer="adafactor",
)

REDUCED = CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, n_patches=16, attention_chunk=64,
                         optimizer="adamw")

SKIP_CELLS = {
    "long_500k": "pure full-attention arch: no sub-quadratic mechanism",
}
