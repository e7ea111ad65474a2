"""whisper-base [audio]: enc-dec; conv frontend STUBBED (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    activation="gelu", norm="layernorm", pos_emb="learned",
    max_seq_len=32768 + 8, cross_attn_period=1,
    n_encoder_layers=6, n_frames=1500, tie_embeddings=True,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab_size=512,
                         max_seq_len=256, n_encoder_layers=2, n_frames=16,
                         attention_chunk=64)

SKIP_CELLS = {
    "long_500k": "full-attention decoder: no sub-quadratic mechanism "
                 "(practical whisper decode ceiling is 448 tokens; "
                 "decode_32k lowered structurally)",
}
