"""llama4-scout-17b-a16e [moe] — 48L d=5120 40H (GQA kv=8) expert d_ff=8192,
vocab=202048, MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  shared_expert=True),
    stages=((("moe",), 48),),
    max_seq=131072, loss_seq_chunk=256,
)
