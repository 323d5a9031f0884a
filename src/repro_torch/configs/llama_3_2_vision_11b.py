"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer.  The vision
tower is a STUB: input_specs() provides precomputed patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, head_dim=128,
    rope_theta=5e5,
    stages=(((("attn",) * 4 + ("cross",)), 8),),
    n_img_tokens=1600,
    max_seq=131072, loss_seq_chunk=512,
)
