"""mamba2-1.3b [ssm] — 48L d=2048 (attention-free), ssm_state=128,
SSD state-space duality [arXiv:2405.21060]."""
from repro_torch.models import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
    stages=((("mamba",), 48),),
    max_seq=524288, loss_seq_chunk=512,
)
