"""Input-shape sets per architecture (the 40 dry-run cells; the port of
``repro.launch.shapes``).

Every LM arch pairs with four shapes:

    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill (serve_step)
    decode_32k   one token, KV cache 32,768, global_batch 128 -> serve_step
    long_500k    one token, KV/state 524,288, global_batch 1  -> serve_step

``long_500k`` requires sub-quadratic attention: it runs for the SSM
(mamba2), hybrid (zamba2) and sliding-window (h2o-danube) archs and is
SKIPPED for pure full-attention archs (recorded per cell; DESIGN.md
§Arch-applicability).  ``batch_specs`` returns tensors on the ``meta``
device (the reference's ``ShapeDtypeStruct`` stand-ins): shapes and
dtypes, no allocation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

TRAIN_4K = "train_4k"
PREFILL_32K = "prefill_32k"
DECODE_32K = "decode_32k"
LONG_500K = "long_500k"

SHAPES = {
    TRAIN_4K: dict(seq_len=4096, global_batch=256, kind="train"),
    PREFILL_32K: dict(seq_len=32768, global_batch=32, kind="prefill"),
    DECODE_32K: dict(seq_len=32768, global_batch=128, kind="decode"),
    LONG_500K: dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k applicability: needs sub-quadratic attention.
SUBQUADRATIC = {"mamba2-1.3b", "zamba2-1.2b", "h2o-danube-1.8b"}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == LONG_500K and arch not in SUBQUADRATIC:
        return False, ("skip: pure full attention — O(L^2) prefill to build "
                       "a 512k cache; run only for SSM/hybrid/SWA archs "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def make_cell(arch: str, shape: str) -> Cell:
    s = SHAPES[shape]
    return Cell(arch=arch, shape=shape, seq_len=s["seq_len"],
                global_batch=s["global_batch"], kind=s["kind"])


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: Cell) -> dict:
    """Meta-device tensors for the data batch of a cell."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        d = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    elif cell.kind == "prefill":
        d = {"tokens": _meta((b, s), torch.int32)}
    else:  # decode: one new token against a cache of seq_len
        d = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.encoder_layers and cell.kind != "decode":
        d["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                            torch.bfloat16)
    if cfg.n_img_tokens and cell.kind != "decode":
        d["img_embeds"] = _meta((b, cfg.n_img_tokens, cfg.d_model),
                                torch.bfloat16)
    return d
