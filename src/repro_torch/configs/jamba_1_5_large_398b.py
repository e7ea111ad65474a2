"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887].  Jamba-1.5 uses Mamba-1
blocks; the reference, and so the port, uses the SSD (Mamba-2) form.  Its
398 B parameters need many cards; the port runs it at ``REDUCED`` size.
"""
from repro_torch.configs.base import MambaSettings, ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    activation="swiglu", norm="rmsnorm", pos_emb="none",
    max_seq_len=1048576,
    attn_layer_period=8,
    moe=MoESettings(num_experts=16, top_k=2, every_k_layers=2,
                    group_size=2048),
    mamba=MambaSettings(d_state=128, d_conv=4, headdim=64, expand=2,
                        n_groups=8, chunk=256),
    optimizer="adafactor",
)

REDUCED = CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=512, attention_chunk=64,
                         moe=MoESettings(num_experts=4, top_k=2,
                                         every_k_layers=2, group_size=64),
                         mamba=MambaSettings(d_state=16, d_conv=4, headdim=16,
                                             expand=2, n_groups=2, chunk=32),
                         optimizer="adamw")

SKIP_CELLS = {}  # hybrid: mamba states + sharded full KV for 9 attn layers
