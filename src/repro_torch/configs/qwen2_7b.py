"""qwen2-7b [dense] — 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
GQA + QKV bias [arXiv:2407.10671]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    stages=((("attn",), 28),),
    max_seq=131072, loss_seq_chunk=512,
)
