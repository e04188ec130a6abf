"""How far a random-weight stack amplifies bf16 rounding noise, by depth.

    PYTHONPATH=src python3 tools/bf16_sensitivity.py [--arch xlstm-1.3b]
        [--layers 8 16 24] [--forward] [--train] [--device cuda]

For each depth, the model at full width (random weights from seed 0) takes
its first decode step twice on one batch of 4 tokens: with every model
matmul as bf16 `x @ w`, then as fp32-summed products rounded to bf16 (what
`mmad` computes). The relative L2 of the two logits is how much a
one-rounding difference per GEMM output grows through the stack; it sets
what a bf16 comparison of two correct paths can promise (chip_smoke.py
holds the recurrent stacks' comparisons in fp32 for this reason). An
encoder-decoder's depth cuts its encoder and decoder alike, and its step
attends to the launcher's stand-in encoder output. `--forward` also runs
the batched forward of 4 x 32 tokens both ways, with a stub frontend's
inputs (4 x n_prefix random patch or frame embeddings x 0.02), and prints
the rel L2 of its logits over every position. `--train` also runs three
AdamW train steps (batch 2 x seq 1024, per-layer remat, lr 1e-4, one
fixed `SyntheticLM` batch, a stub frontend's inputs as above) both ways
from the same weights, and prints the relative difference of the loss
before each step and after the last and of each step's grad norm: what a
routed train trajectory (fp32-summed `mmad`, forward and backward) can
promise against an unrouted one (bf16 `x @ w` and PyTorch's backward).
Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import resolve_device  # noqa: E402
from repro_torch.launch.serve import encoder_output  # noqa: E402
from repro_torch.models.model import (decode_init, decode_step,  # noqa: E402
                                      forward, init_params)


def first_step(params, cfg, tokens, fp32_sums: bool,
               encoder_out=None, forward_inputs=None) -> torch.Tensor:
    """The first decode step's logits (with `forward_inputs`, a dict of
    `forward`'s keyword arguments, the forward's), unrouted, with every
    model matmul (the modules' `pmm`) as bf16 `x @ w` or as fp32 sums
    rounded."""
    with matmuls(fp32_sums), torch.inference_mode():
        if forward_inputs is not None:
            return forward(params, tokens, cfg, **forward_inputs)
        caches = decode_init(params, cfg, tokens.shape[0], 1)
        return decode_step(params, caches, tokens, 0, cfg,
                           encoder_out=encoder_out)[0]


@contextlib.contextmanager
def matmuls(fp32_sums: bool):
    """Every model matmul (the modules' `pmm`, the loss's too), unrouted,
    as bf16 `x @ w` or as fp32 sums rounded to the operands' dtype (whose
    backward then sums in fp32 too)."""
    from repro_torch.models import attention, common, model, moe, ssm
    from repro_torch.train import steps

    def pmm(x, w, tag=""):
        if fp32_sums:
            return (x.float() @ w.float()).to(x.dtype)
        return x @ w

    modules = (attention, common, model, moe, ssm, steps)
    saved = [m.pmm for m in modules]
    for m in modules:
        m.pmm = pmm
    try:
        yield
    finally:
        for m, f in zip(modules, saved):
            m.pmm = f


def train_trajectory(cfg, device, batch, fp32_sums: bool):
    """Three AdamW steps at lr 1e-4 (the launcher's schedule for three
    steps) on one fixed batch from the seed-0 weights: the loss before
    each step and after the last, each step's grad norm."""
    from repro_torch.models.model import make_trainable
    from repro_torch.optim import adamw
    from repro_torch.train.steps import loss_fn, make_train_step

    steps = 3
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=5, total_steps=steps)
    step = make_train_step(cfg, opt)
    params = make_trainable(init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device))
    state = (params, adamw.init(params), None)
    losses, norms = [], []
    with matmuls(fp32_sums):
        for _ in range(steps):
            *state, m = step(*state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        with torch.no_grad():
            losses.append(float(loss_fn(state[0], batch, cfg)))
    return losses, norms


def frontend_inputs(cfg, rng, batch: int, device):
    """A stub frontend's random inputs (x 0.02), or none."""
    if cfg.frontend == "none":
        return {}
    key = "encoder_embeds" if cfg.is_encoder_decoder else "prefix_embeds"
    return {key: torch.as_tensor(
        rng.standard_normal((batch, cfg.n_prefix, cfg.d_model)) * 0.02,
        dtype=cfg.dtype, device=device)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 16, 24])
    ap.add_argument("--forward", action="store_true",
                    help="also compare the batched forward of 4 x 32 tokens")
    ap.add_argument("--train", action="store_true",
                    help="also compare three train steps at batch 2 x seq "
                         "1024")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    full = get_config(args.arch)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for n in args.layers:
        cfg = dataclasses.replace(
            full, n_layers=n,
            n_encoder_layers=n if full.is_encoder_decoder else 0)
        params = init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
        gen = torch.Generator(device="cpu").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen).to(
            device)
        rng = np.random.default_rng(0)
        encoder_out = (encoder_output(params, cfg, 4, rng, device)
                       if cfg.is_encoder_decoder else None)
        a, b = (first_step(params, cfg, tokens[:, :1], fp32_sums=f,
                           encoder_out=encoder_out) for f in (False, True))
        rel = float((a - b).norm() / a.norm())
        depth = (f"{n} + {n} of {full.n_encoder_layers} + {full.n_layers}"
                 if cfg.is_encoder_decoder else f"{n} of {full.n_layers}")
        print(f"{args.arch} at {depth} layers on {name}: "
              f"first-step logits, bf16 x @ w against fp32 sums rounded to "
              f"bf16: rel L2 {rel:.3e}", flush=True)
        if args.forward:
            inputs = frontend_inputs(cfg, rng, 4, device)
            a, b = (first_step(params, cfg, tokens, fp32_sums=f,
                               forward_inputs=inputs) for f in (False, True))
            rel = float((a - b).norm() / a.norm())
            extra = " and the frontend inputs" if inputs else ""
            print(f"{args.arch} at {depth} layers on {name}: forward logits "
                  f"of 4 x 32 tokens{extra}, bf16 x @ w against fp32 sums "
                  f"rounded to bf16: rel L2 {rel:.3e}", flush=True)
        del params
        if args.train:
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                          global_batch=2)).batch(0)
            batch = {k: torch.from_numpy(v).to(device, torch.long)
                     for k, v in data.items()}
            batch.update(frontend_inputs(cfg, rng, 2, device))
            (la, na), (lb, nb) = (train_trajectory(cfg, device, batch, f)
                                  for f in (False, True))
            loss_rel = [abs(x - y) / abs(y) for x, y in zip(lb, la)]
            norm_rel = [abs(x - y) / abs(y) for x, y in zip(nb, na)]
            print(f"{args.arch} at {depth} layers on {name}: three train "
                  f"steps (batch 2 x seq 1024, lr 1e-4), fp32 sums rounded "
                  f"against bf16 x @ w: losses {lb} vs {la} (rel "
                  f"{[f'{x:.2e}' for x in loss_rel]}); grad norms {nb} vs "
                  f"{na} (rel {[f'{x:.2e}' for x in norm_rel]})", flush=True)


if __name__ == "__main__":
    main()
