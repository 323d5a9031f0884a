"""qwen2.5-14b [dense] — 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
GQA + QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    stages=((("attn",), 48),),
    max_seq=131072, loss_seq_chunk=512,
)
