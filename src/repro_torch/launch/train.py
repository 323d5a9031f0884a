"""End-to-end training driver (the port of ``repro.launch.train``): runs
a reduced config on the card, or on the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --steps 100 --batch 8 --seq 128 --device cpu

Features: deterministic data pipeline, AdamW + cosine schedule, gradient
accumulation, checkpoint/restart (fault tolerant).  As in the reference,
``--smoke`` is on whatever the command line says, so the CLI always
trains the smoke config; training takes the plain routes
(``attn_impl="torch"``), the port's counterpart of the reference's
``"xla"``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.ft import FaultTolerantTrainer, TrainerConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models import init_params, smoke_config
from repro_torch.optim import AdamWConfig, adamw_init


def make_state_fns(cfg, ocfg, seed=0, device="cuda"):
    def init_state():
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            seed), device=device)
        return {"params": params, "opt": adamw_init(params)}
    return init_state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-1.3b",
                   choices=configs.all_archs())
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg, attn_impl="torch")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                       clip_norm=1.0)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    step = steps_mod.make_train_step(cfg, ocfg, accum_steps=args.accum)

    def step_fn(state, batch):
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in batch.items()}
        params, opt, metrics = step(state["params"], state["opt"], batch)
        return ({"params": params, "opt": opt},
                {"loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"])})

    trainer = FaultTolerantTrainer(
        TrainerConfig(checkpoint_dir=args.ckpt_dir,
                      checkpoint_every=args.ckpt_every),
        step_fn, pipe, make_state_fns(cfg, ocfg, device=args.device))
    t0 = time.time()
    out = trainer.run(args.steps)
    losses = [m["loss"] for m in out["metrics"]]
    print(f"arch={cfg.name} steps={out['final_step']} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({time.time() - t0:.1f}s, restarts={out['restarts']})")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, **out}


if __name__ == "__main__":
    main()
