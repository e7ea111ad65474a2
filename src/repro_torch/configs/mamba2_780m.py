"""mamba2-780m [ssm]: attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs.base import MambaSettings, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=1,
    activation="swiglu", norm="rmsnorm", pos_emb="none",
    max_seq_len=1048576, tie_embeddings=True,
    mamba=MambaSettings(d_state=128, d_conv=4, headdim=64, expand=2,
                        n_groups=1, chunk=256),
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, vocab_size=512,
                         max_seq_len=512,
                         mamba=MambaSettings(d_state=16, d_conv=4, headdim=16,
                                             expand=2, n_groups=1, chunk=32))

SKIP_CELLS = {}  # SSM: constant-size state -> long_500k is the headline cell
