"""Model zoo of the port: the layer-pattern architectures of
``repro.models`` in PyTorch, on the hand-written CUDA kernels: dense
attention (with sliding windows), cross-attention over an encoder's or an
image memory, mixture of experts, Mamba-2 and the Zamba-2 hybrid
(forward, loss and its gradient on the plain route, prefill, decode)."""
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
