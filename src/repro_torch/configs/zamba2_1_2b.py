"""zamba2-1.2b [hybrid] — 38L d=2048, Mamba-2 blocks with a SHARED attention
block (32H MHA, d_ff=8192) applied every 6th layer, ssm_state=64
[arXiv:2411.15242]."""
from repro_torch.models import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1),
    stages=(
        (("mamba", "mamba", "mamba", "mamba", "mamba", "hybrid"), 6),
        (("mamba",), 2),
    ),
    max_seq=524288, loss_seq_chunk=512,
)
