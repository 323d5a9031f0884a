"""h2o-danube-1.8b [dense] — 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Llama+Mistral mix with sliding-window attention [arXiv:2401.16818]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, head_dim=80,
    sliding_window=4096, rope_theta=1e4,
    stages=((("attn",), 24),),
    max_seq=524288, loss_seq_chunk=512,
)
