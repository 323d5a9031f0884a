"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000. No bias [hf:CohereForAI/c4ai-command-r-plus]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    qkv_bias=False, rope_theta=75e4,
    stages=((("attn",), 64),),
    max_seq=131072, loss_seq_chunk=256,
)
