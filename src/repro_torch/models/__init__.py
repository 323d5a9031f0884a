"""Model zoo of the port: the layer-pattern architectures of
``repro.models`` in PyTorch, on the hand-written CUDA kernels.  Ported so
far: dense attention (with sliding windows), mixture of experts, Mamba-2
and the Zamba-2 hybrid (forward, loss, prefill, decode); cross-attention
and the encoders are not in the port yet."""
from repro_torch.models.config import (KINDS, ModelConfig, MoEConfig,
                                       SSMConfig, smoke_config)
from repro_torch.models.model import (abstract_params, decode_step, forward,
                                      init_cache, init_params, loss_fn,
                                      model_meta, prefill, unembed)

__all__ = [
    "KINDS", "ModelConfig", "MoEConfig", "SSMConfig", "smoke_config",
    "abstract_params", "decode_step", "forward", "init_cache", "init_params",
    "loss_fn", "model_meta", "prefill", "unembed",
]
