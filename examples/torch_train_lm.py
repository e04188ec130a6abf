"""End-to-end run on the PyTorch port: train a reduced LM for a few
hundred steps with checkpointing + resume, then greedy-decode a sample
from it.

  PYTHONPATH=src python examples/torch_train_lm.py --arch olmo-1b --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 101

The counterpart of examples/train_lm.py. It runs on the card unless
`--device cpu` is given; with no card it raises (nothing falls back to
the CPU). Like the reference's example it runs unrouted: no GEMM context
is installed, so every model matmul is `x @ w`. The port's step updates
the parameters and AdamW state in place, so `run_training` takes a
factory of fresh states, not a state. `main` prints the reference's lines
and returns the values it printed.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.ft.runtime import LoopConfig, run_training
from repro_torch.launch.mesh import resolve_device
from repro_torch.models.model import decode_init, init_params, make_trainable
from repro_torch.optim import adamw, compress
from repro_torch.train.steps import make_serve_step, make_train_step

PROMPT_TOKENS = NEW_TOKENS = 16


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_example_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    train_step = make_train_step(cfg, opt, microbatches=2,
                                 compress_grads=True)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = make_trainable(init_params(gen, cfg, device))
        return params, adamw.init(params), compress.init(params)

    def step_fn(state, batch):
        p, o, c = state
        p, o, c, m = train_step(p, o, c, batch)
        return (p, o, c), m

    shutil.rmtree(args.ckpt, ignore_errors=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f}", flush=True)

    state = run_training(
        step_fn, init_state, data,
        LoopConfig(total_steps=args.steps, ckpt_every=100,
                   ckpt_dir=args.ckpt),
        make_batch_arrays=lambda b: {k: torch.from_numpy(v).to(device,
                                                               torch.long)
                                     for k, v in b.items()},
        on_metrics=on_metrics)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"\nloss: {first:.3f} -> {last:.3f} over {args.steps} steps")

    # greedy-decode a continuation from the trained model
    params = state[0]
    serve = make_serve_step(cfg)
    prompt = data.batch(0)["tokens"][:1, :PROMPT_TOKENS]
    out = []
    with torch.inference_mode():
        caches = decode_init(params, cfg, 1, 48)
        tokens = torch.from_numpy(prompt).to(device, torch.long)
        for i in range(PROMPT_TOKENS):
            logits, caches = serve(params, caches, tokens[:, i:i + 1], i)
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(NEW_TOKENS):
            out.append(int(tok[0, 0]))
            logits, caches = serve(params, caches, tok, PROMPT_TOKENS + i)
            tok = torch.argmax(logits, -1)[:, None]
    print("prompt tokens:", prompt[0].tolist())
    print("continuation :", out)
    return {"losses": losses, "first_loss": first, "last_loss": last,
            "prompt": prompt[0].tolist(), "continuation": out,
            "device": str(device)}


if __name__ == "__main__":
    main()
