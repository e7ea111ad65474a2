"""granite-34b [dense]: code model, MQA (kv=1), GPT-BigCode-style
[arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    activation="gelu", norm="layernorm", pos_emb="learned",
    max_seq_len=32768,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, attention_chunk=64)

SKIP_CELLS = {
    "long_500k": "pure full-attention arch: no sub-quadratic mechanism",
}
