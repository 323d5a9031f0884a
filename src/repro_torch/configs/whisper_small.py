"""whisper-small [audio] — enc-dec, 12+12L d=768 12H d_ff=3072 vocab=51865.
Conv frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, 1500, d) [arXiv:2212.04356]."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    norm="layernorm", act="gelu",
    stages=((("cross",), 12),),
    encoder_layers=12, encoder_seq=1500,
    max_seq=32768, loss_seq_chunk=512,
)
