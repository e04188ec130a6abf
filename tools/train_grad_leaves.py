"""Where a random recurrent stack's step-0 gradients move with the order
its GEMMs sum in, leaf by leaf, on the card (needs one CUDA device).

    python3 tools/train_grad_leaves.py [--arch xlstm-1.3b] [--layers 8 16]

For each depth, the launcher's seed-0 weights at full width cast up to fp32
(as `chip_smoke.fp32_trajectory` holds them) take the loss and gradients of
one train step (batch 2 x seq 1024, per-layer remat, the launcher's first
`SyntheticLM` batch) five ways, every model matmul (the modules' `pmm`,
the loss's too):

- `x @ w`: unrouted, cuBLAS fp32, PyTorch's backward; then again, which
  is its noise floor;
- `fp64 sums`: each product summed in fp64 and rounded to fp32 (its
  backward too), the yardstick;
- `K halves`: each product as two fp32 `x @ w` over the halves of K,
  added: another fp32 summation order;
- `routed`: the launcher's routing context, `mmad`'s SIMT tile kernel
  forward and fp32 `torch.matmul` backward, as the train phase runs it.

Prints, for each against the yardstick (and the repeat against the first
run): the loss's and the grad norm's relative difference, each layer's
relative L2 (all of its leaves), and the worst leaves. Then
`chip_smoke.block_operand_check`: the routed gradients held leaf by leaf on
their own operands. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 2, 1024


@contextlib.contextmanager
def matmuls(torch, mode: str):
    """Every model matmul as `mode` says (see the module docstring)."""
    from repro_torch.models import attention, common, model, moe, ssm
    from repro_torch.train import steps

    def pmm(x, w, tag=""):
        if mode == "fp64 sums":
            return (x.double() @ w.double()).to(x.dtype)
        if mode == "K halves":
            h = x.shape[-1] // 2
            return x[..., :h] @ w[:h] + x[..., h:] @ w[h:]
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


def layer_of(name: str) -> str:
    """A leaf's layer group (`mlstm_layers.3`), or the leaf itself."""
    m = re.match(r"(\w+_layers\.\d+)\.", name)
    return m.group(1) if m else name


def compare(torch, got, want) -> dict:
    """Relative L2 of each leaf and each layer, and of the grad norm."""
    leaves, layers = {}, {}
    for k, w in want.items():
        d2 = float(((got[k].double() - w.double()) ** 2).sum())
        n2 = float((w.double() ** 2).sum())
        leaves[k] = (d2 / n2) ** 0.5
        acc = layers.setdefault(layer_of(k), [0.0, 0.0])
        acc[0] += d2
        acc[1] += n2
    norm = sum(a[1] for a in layers.values()) ** 0.5
    got_norm = sum(float((g.double() ** 2).sum()) for g in got.values()) ** 0.5
    return {"leaves": leaves,
            "layers": {k: (d / n) ** 0.5 for k, (d, n) in layers.items()},
            "norm_rel": abs(got_norm - norm) / norm, "norm": got_norm}


def report(label: str, loss, ref_loss, cmp: dict) -> None:
    worst = sorted(cmp["leaves"].items(), key=lambda kv: -kv[1])[:5]
    print(f"  {label}: loss {loss:.9g} (rel {abs(loss - ref_loss) / ref_loss:.2e}"
          f"), grad norm {cmp['norm']:.6g} (rel {cmp['norm_rel']:.2e}); "
          f"per layer rel L2 "
          + " ".join(f"{k.replace('_layers', '')}:{v:.1e}"
                     for k, v in cmp["layers"].items())
          + "; worst leaves " + ", ".join(f"{k} {v:.2e}" for k, v in worst),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 16])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_grad_leaves: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params, make_trainable
    from repro_torch.obs import set_tracer
    from repro_torch.train import steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for n in args.layers:
        cfg = dataclasses.replace(get_config(args.arch), n_layers=n)
        s = train.setup(train.parse_args(
            ["--arch", args.arch, "--device", "cuda", "--batch", str(BATCH),
             "--seq", str(SEQ), "--plan-cache",
             str(ROOT / "build" / "grad_leaves_plans")]), cfg=cfg)
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
        batch = chip_smoke.launcher_batch(torch, s)
        cfg32, params = chip_smoke.fp32_copy(torch, s.cfg, init_params(
            torch.Generator(device=dev).manual_seed(0), s.cfg, dev))
        make_trainable(params)

        def step0(mode):
            if mode == "routed":
                ctx = serve.install_gemm_context(s.planner, dev)
                cm = contextlib.nullcontext()
            else:
                ctx, cm = None, matmuls(torch, mode)
            try:
                with cm:
                    loss, grads = steps.loss_and_grads(params, batch, cfg32)
            finally:
                shard_ctx.set_gemm_context(None)
            if ctx is not None and (ctx.stats.resolve_rate != 1.0
                                    or ctx.stats.silent_degrades):
                raise SystemExit("the routed step did not resolve every GEMM")
            return float(loss), {k: g.detach() for k, g in grads.items()}

        print(f"{args.arch} at {n} of {get_config(args.arch).n_layers} "
              f"layers in fp32 on {torch.cuda.get_device_name(dev)}, step 0 "
              f"(batch {BATCH} x seq {SEQ}), against fp64 sums:", flush=True)
        ref_loss, ref = step0("fp64 sums")
        loss_a, a = step0("x @ w")
        report("x @ w", loss_a, ref_loss, compare(torch, a, ref))
        loss_b, b = step0("x @ w")
        report("x @ w again, against the first", loss_b, loss_a,
               compare(torch, b, a))
        del a, b
        for mode in ("K halves", "routed"):
            loss_m, g = step0(mode)
            report(mode, loss_m, ref_loss, compare(torch, g, ref))
            del g
        del ref, params
        torch.cuda.empty_cache()
        chip_smoke.block_operand_check(torch, s, batch, dev)
        del s, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
