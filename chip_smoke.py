"""On-card smoke check of the PyTorch/CUDA port (needs one NVIDIA H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — the card's name and power limit (nvidia-smi) and versions;
2. build   — compile every CUDA kernel of the main paths from the
             checkout's sources (`src/repro_torch/kernels/csrc/*.cu`);
3. kernels — each kernel against its plain PyTorch version on the card,
             through the wrapper the main path calls: every input dtype at
             all five gemma-2b decode shapes (lm_head on the full 256000-
             column `embed.T` view), a bm = 2 geometry, a non-power-of-two
             geometry, a ragged shape and a strided B; both stream kernels
             must be reached split and unsplit, and both tile kernels (the
             SIMT one and the tensor-core one); and bf16 at the five
             gemma-2b train shapes (M = 2048; lm_head per loss chunk, M =
             1024, on `embed.T`) and at their backward's products (da = g
             @ b.T, db = a.T @ g, on the views), which must all take the
             tensor-core kernel;
4. serve   — full-width, full-depth gemma-2b (random weights from a seed)
             through `repro_torch.launch.serve`: batch 4, prompt 32, gen
             32. Asserts plan-resolve rate 1.0, no silent degrade, one
             `mmad` launch per routed GEMM dispatch, an observed workload
             equal to `model_workload`'s, finite logits, and first-step
             logits that match an unrouted run; then the device busy share
             of the same decode steps, read from one profiled window
             (`device_profile`: padded at its edges, which the profiler may
             lose), in which every routed GEMM must be one mmad kernel and
             no split-K reduce kernel may run;
5. train   — full-width, full-depth gemma-2b (random weights from a
             seed) through `repro_torch.launch.train`'s own setup: batch 2,
             seq 1024, lr 1e-4, three steps on one fixed `SyntheticLM`
             batch with per-layer remat, first unrouted (the yardstick),
             then routed from the same weights. Asserts plan-resolve rate
             1.0, no silent degrade, one `mmad` launch per routed GEMM
             dispatch (forward and recompute), finite losses and grad
             norms, a routed trajectory that follows the unrouted one (loss
             before each step and after the last, grad norm of each step,
             every step moving the loss the same way) and a loss that ends
             below its start; the backward's two products of every forward
             dispatch launch `mmad` too, so launches = dispatches + 2 x
             backward calls, and every `local_matmul` backward call must
             take those products (none the fp32 ones); then one profiled
             step, in which every `mmad` kernel must be the tensor-core
             kernel, as many as the step's launches, and no GEMM kernel
             may read fp32 operands (no SIMT sgemm). Then
             the crash-resume loop at smoke width on the card: a failure
             injected at step 3 with a checkpoint every 2 steps must end
             on the parameters of an uninterrupted run, bitwise;
   train gemma-2b sharded — the train phase's model, weights, batch and
             plans through `launch.train.setup(..., mesh=...)` on
             `make_dist_mesh((1, 1))` over an NCCL world of one rank
             (NCCL puts one rank on each card): parameters, AdamW moments
             and residuals kept as `spec_rules` blocks and gathered on use
             (`parallel/sharded.py`), whole on one rank. Its losses, grad
             norms and final parameters must equal the routed run's
             bitwise, its `mmad` launches per step too, its state bytes
             the `spec_rules` bytes; its peak is printed. Then at smoke
             width a sharded checkpoint saved and restored, and
             `elastic_reshard` onto the same and a new 1x1 mesh, bitwise;
             then SHARDED_HOST_RANKS gloo CPU processes on the card's
             host train smoke gemma-2b in fp32 on the 2x2 and the 2x1x2
             `pod x data x model` meshes, unrouted and routed, held to the
             unsharded step (`host_sharded_run`);
   serve gemma-2b --traffic [bucket], [fifo] — `serve.main` with
             `--traffic` at full width in both batch modes (2 tenants x 12
             requests, seed 0): the run report's `serving` section must
             equal `simulate`'s without dispatch on the same trace and
             planner, plan-resolve rate 1.0, no silent degrade, one `mmad`
             launch per distinct shape dispatched, one `serve.request`
             marker per request; each M's route (stream kernels up to 16
             rows, the tensor-core kernel above, FIFO's ragged M's on its
             masked edges) and every dispatched shape held to the plain
             version on random operands. Its goodput and latencies are the
             cost model's virtual clock, not the card's time;
6. serve deepseek-moe-16b and serve qwen3-14b — the serve phase's
             checks at full width and depth for the MoE model (28 layers,
             64 routed experts top-6 + 2 shared; the router on `mmad` in
             fp32) and the dense GQA model with qk-norm (40 layers, 40 / 8
             heads). For the MoE model the first step's expert choices are
             counted: between the routed and unrouted runs, and between
             the two routers on the same input, each bounded; its logits
             are held to the unrouted step's with the routed choices
             pinned. One traced step splits `mmad` time from the kernels
             of the MoE einsums (`moe.einsums` span). Plan warm-up time and
             each phase's peak memory are printed; each model is freed
             before the next phase;
   serve deepseek-v2-236b — the same at full width and 6 layers (1 dense +
             5 MoE of 160 routed experts; the full 60 do not fit one card):
             MLA decodes in its absorbed form, and the run report must
             show `model_workload`'s shapes, `mla.*` included; then, on
             the same weights, one routed batched forward of the prompt
             runs MLA's naive form (its GEMMs at M = 128 on the
             tensor-core kernel), held to the absorbed decode's logits at
             the last prompt position with the decode's expert choices
             pinned (`naive_vs_absorbed`);
   serve zamba2-1.2b and serve xlstm-1.3b — the serve phase's checks at
             full width and full depth for the recurrent stacks (38 Mamba2
             layers and one shared attention block used after each of 6
             super-layers; 42 mLSTM and 6 sLSTM layers, the fp32
             `mlstm.gates` on `mmad` at N = 8). One traced step splits
             `mmad` time from the state updates' kernels (the
             `mamba.state`, `mlstm.state` and `slstm.state` spans); then,
             on the same weights, one routed batched forward of 2 x 256
             tokens runs the chunked forms (two chunks; its GEMMs at M =
             512 on the tensor-core kernel, `mamba.in`'s N = 8,384 ragged,
             the fp32 gates on the SIMT tile kernel, each call held to the
             plain version on its operands and each shape at the plan's
             block) against the recurrent decode fed the same tokens one
             at a time, the logits at every position held in fp32 on the
             same weights and printed in bf16 (`chunked_vs_recurrent`);
             their first-step routed-vs-unrouted check likewise;
   serve seamless-m4t-medium and serve phi-3-vision-4.2b — the serve
             phase's checks at full width and depth for the
             encoder-decoder (12 + 12 layers, vocab 256,206, every step
             attending to the launcher's stand-in encoder output: its
             decoder's cross-attention K and V re-projected from the 4 x
             960 encoder rows on the tensor-core kernel, 24 of a step's
             133 `mmad` kernels, counted by name in the profile, the rest
             on the stream kernels) and the VLM (32 layers of MHA 32 x 96,
             decoding text). Then, on the same weights, seamless's
             `encoder_vs_decode`: one routed forward of 4 x 960 random
             frames (the encoder non-causal at M = 3,840) and the prompt,
             against the routed decode of the prompt on that forward's own
             encoder output, the logits at every prompt position held in
             bf16; and phi-3-vision's `prefix_forward`: one routed forward
             of 4 x 576 random patch embeddings (`frontend.proj` at M =
             2,304) and the prompt (M = 2,432; lm_head on `embed.T` with a
             ragged last tile) against the unrouted forward, held in bf16.
             Each forward's `mmad` calls are held on their own operands,
             every bf16 call past the stream kernels' rows must take the
             tensor-core kernel, and each shape is held at the plan's
             block;
   train deepseek-moe-16b — the train phase's checks at full width and 4
             layers (1 dense + 3 MoE; AdamW over the full 28 needs more
             than 200 GB): routed first, each route call's expert choices
             recorded and checked against `x @ w` on the same input, then
             unrouted with those choices pinned as the yardstick; the fp32
             router runs forward on the SIMT tile kernel and backward as
             fp32 `torch.matmul`, which the launch census and the profile
             count apart;
   train deepseek-v2-236b, zamba2-1.2b, xlstm-1.3b, seamless-m4t-medium,
             phi-3-vision-4.2b — the train phase's checks at full width:
             deepseek-v2-236b at V2_TRAIN_LAYERS of 60 (MLA's naive form
             with `mla.*` in both backward products, attention at head
             dim 192 for q and k and 128 for v); the recurrent
             stacks through the launcher (zamba2 at full depth, its 38
             Mamba2 layers and 6 applications of its shared block,
             `mamba.in`'s N = 8,384 in the backward; xlstm at
             XLSTM_TRAIN_LAYERS of 48, 14 mLSTM and 2 sLSTM layers, its
             fp32 gates counted as the router is), the frontend models
             through the launcher's `make_train_step` on a
             batch this script builds (`frontend_batch`: the launcher's
             tokens and TRAIN_BATCH x n_prefix random frames or patches),
             seamless at full depth (12 + 12 layers; lm_head's N =
             256,206), phi-3-vision at PHI3_TRAIN_LAYERS of 32 (1,600 rows
             a sequence: `chunked_sdpa` forward and backward). xlstm's
             trajectory is held on fp32 copies of its weights and its
             first bf16 step's `mmad` calls on their own operands
             (FP32_HELD_TRAIN), its step-0 gradients in fp32 leaf by leaf
             on their own operands (`block_operand_check`); the recurrent
             stacks' scans sum in fp32, and their profiles count the scans'
             fp32 library GEMMs, each scan replayed alone
             (`scan_library_gemms`). Each prints its step ms, tokens/s,
             model FLOPs (`launch/flops.py`) as a share of the bf16 peak,
             peak GB and busy share; xlstm the wall ms of its sLSTM
             recurrence timed in one step (`slstm_split`);
7. chunked_sdpa — `chunked_sdpa` against `_sdpa` at b = 1, seq 4096
             (and a ragged 4000), bf16, causal, gemma-2b's heads (8 / 1 /
             256) and qwen3-14b's (40 / 8 / 128): forward and the grads of
             q, k and v within `ATTN_TOL`, then their times beside
             `scaled_dot_product_attention`'s and their peak memory;
   dryrun  — a host phase, nothing on the card: `launch/dryrun.py` at
             full configuration over its fake 16x16 world on the meta
             device, a record-only gemma-2b train_4k cell and a routed
             gemma-2b decode_32k cell as two processes at once
             (`dryrun_cells`): both ok, the routed cell resolving every
             plan with no silent degrade, `model_workload` covered but for
             the train lm_head the loss chunks, the useful-FLOP ratio
             printed, the phase within DRYRUN_LIMIT_S;
8. timing  — per decode shape (gemma-2b, deepseek-moe-16b with its fp32
             router, qwen3-14b, deepseek-v2-236b, zamba2-1.2b, xlstm-1.3b
             with its fp32 gates, seamless-m4t-medium with its cross K/V
             and its 256,206-column lm_head, phi-3-vision-4.2b), per shape
             of the two frontend forwards, and per train shape
             (gemma-2b, deepseek-moe-16b with its fp32 router on the SIMT
             tile kernel, the five other families, xlstm's fp32 gates on
             the SIMT tile kernel), and per distinct shape of the two
             traffic replays, the kernel's time (held to the
             tolerance again) beside the plain version's, one
             `torch.matmul` call's, the bound and the roofline share
             (bound / kernel time); per bf16
             train shape also its TFLOPS and its backward's two `mmad`
             products beside their plain version, bf16 `torch.matmul` and
             their bound (the router's: its fp32 `torch.matmul` products);
             and the expert einsums per decode step (both MoE models) and
             per train step, forward and backward, beside their bounds;
9. report  — per served model its tok/s, `mmad` ms per step against
             its bound and `torch.matmul`'s, and its held comparisons'
             errors; per trained model its step ms, tokens/s, model FLOP
             share, peak and `mmad` forward and backward ms against their
             bounds and `torch.matmul`'s; one JSON line per kernel and
             path (the frontend forwards' and the train paths' too), the
             total time, the nvidia-smi line, and last the `{"ok": true,
             "device": ...}` line.

Exits 2 with no result when no CUDA device is present. Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
H100_BYTES_PER_S = 3.35e12          # H100 SXM data sheet: HBM3 bandwidth
H100_BF16_FLOPS = 989.4e12          # H100 SXM data sheet: dense bf16 tensor
H100_FP32_FLOPS = 67e12             # H100 SXM data sheet: fp32, CUDA cores
BATCH, PROMPT, GEN = 4, 32, 32
SEED = 0
# the train phase: the longest sequence the ported attention takes without
# `chunked_sdpa`; two loss chunks of 512. At lr 1e-3 (the launcher's
# default) Adam's first sign-like steps overshoot on full-width random
# gemma-2b, routed and unrouted alike: the loss over three steps on one
# batch went 12.83 -> 10.38 -> 11.65, then 17.1; at lr <= 3e-4 it ends below
# its start (tools/train_lr_probe.py, on an H100)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 1024, 3, 1e-4
# The routed train run against an unrouted one from the same weights on the
# same batch, relative: the loss before each step and after the last, and
# each step's grad global norm. The unrouted run is cuBLAS bf16 GEMMs and
# PyTorch's own backward; the routed one is mmad with fp32 sums, forward
# and backward. Both round every GEMM output and every gradient to bf16
# (2^-8 relative) at other points. The limits were set when the routed
# backward was fp32 `torch.matmul`: on an H100, step 0 read
# 7.7e-5 (loss) and 8.0e-5 (grad norm); later steps, which start from
# parameters the two runs moved with those different grads, read at most
# 2.8e-4 (loss) and 5.5e-4 (grad norm). Each limit is about ten times its
# reading.
STEP0_REL = 1e-3
LATER_LOSS_REL, LATER_GNORM_REL = 3e-3, 5e-3
# (m, k, n, block, transposed B): gemma-2b's train GEMMs at batch 2 x seq
# 1024 and the plans' block geometry (the tensor-core kernel reads none of
# it)
TRAIN_CASES = [
    (2048, 2048, 2048, (512, 512, 512), False),     # q, o
    (2048, 2048, 256, (128, 256, 512), False),      # k, v: split K
    (2048, 2048, 16384, (512, 512, 512), False),    # gate, up
    (2048, 16384, 2048, (512, 512, 512), False),    # down
    (1024, 2048, 256000, (512, 128, 512), True),    # lm_head chunk, embed.T
]
# Routed vs unrouted first-step logits, relative L2. Both runs round each
# of the step's 127 GEMM outputs to bf16 (2^-8 relative) from fp32 sums
# taken in different orders; one-ulp flips then travel through 18 layers of
# untrained random weights, which amplify them (measured 1.8e-2 on an H100).
FIRST_STEP_REL_L2 = 5e-2
# MoE first step. The two routers' logits differ by summation order alone
# (fp32 mmad against fp32 x @ w, ~1e-6): a choice flips on the same input
# only where the k-th and (k+1)-th gates tie that closely, which random
# weights make rare (~1e-5 per token-layer), so at most one is allowed.
# Between the routed and unrouted runs the layers' inputs differ by bf16
# roundings taken in other orders, and a choice flips where those move a
# gate across its neighbour; a router computing anything else would
# disagree on nearly every token-layer.
SAME_INPUT_FLIPS = 1
MOE_FLIP_SHARE = 0.2
# MoE training (deepseek-moe-16b at full width, MOE_TRAIN_LAYERS deep: 1
# dense + 3 MoE layers, 2.27 B parameters, ~27 GB with AdamW's fp32
# moments; the full 28 layers need more than 200 GB). Same-input router
# flips over all its route calls (forward, recompute, final loss): 2,048
# tokens x 3 layers x 7 calls; a near-tie within fp32 summation noise is
# ~1e-5 per token-layer (see above), so this allows ten times that.
MOE_TRAIN_LAYERS = 4
TRAIN_SAME_INPUT_FLIP_SHARE = 1e-4
# The other families' train phases (TRAIN_PHASES), at the train phase's
# batch, seq and steps: zamba2-1.2b and xlstm-1.3b through the launcher,
# seamless-m4t-medium and phi-3-vision-4.2b through the launcher's
# `make_train_step` on a batch this script builds with their frontend
# inputs (`frontend_batch`). Depth: phi-3-vision trains all of its 32
# layers, since their peak read 55.14 GB on an H100 (72 GB was the
# limit); xlstm trains XLSTM_TRAIN_LAYERS of its 48 (2 of its 6
# super-layers of 7 mLSTM + 1 sLSTM), since its sLSTM's 1,024-step loop
# bounds the step on the host: 21 s a step at full depth, 4.8–6.1 s at
# 16 layers, on an H100. Learning rates, from three steps on the fixed batch
# on an H100: phi-3-vision at 1e-4 went 10.89 -> 12.73 -> 13.04 -> 10.90
# (routed and unrouted alike), at 3e-5 10.89 -> 8.07 -> 8.03 -> 7.90;
# xlstm at 1e-4 (full depth, routed) went 11.329 -> 11.332, and at 16
# layers (unrouted) fell 1 % at 3e-4 and went 11.31 -> 10.23 at 1e-3
# (`tools/train_lr_probe.py`).
PHI3_TRAIN_LAYERS = 32
PHI3_TRAIN_LR = 3e-5
XLSTM_TRAIN_LAYERS = 16
XLSTM_TRAIN_LR = 1e-3
# A random xlstm amplifies its GEMMs' roundings through its depth: in
# fp32 at 16 layers, step 0, against each product summed in fp64, cuBLAS's
# `x @ w` moved its layers' gradients by 9.3e-2 to 0.41 (relative L2) and
# another fp32 order (K summed in two halves) moved its grad norm by
# 2.4e-2, while the routed run (`mmad`'s SIMT tile kernel) moved them by
# 8.8e-2 to 0.13 and 2.7e-2; at 8 layers all of these were ~2e-2 and below
# (`tools/train_grad_leaves.py` on an H100). So its step-0 grad norm can
# hold no two correct fp32 runs to each other, and its bf16 run (bf16
# `x @ w` against fp32 sums rounded moved its step-2 grad norm by 0.32 at
# 48 layers, `tools/bf16_sensitivity.py --train`) even less. Its
# trajectory is held on fp32 copies of the weights (`fp32_trajectory`),
# where a mean loss averages the noise away: the step-0 loss at STEP0_REL,
# each run's loss ending below its start, the grad norms and later steps
# printed. Its step-0 gradients are held leaf by leaf on their own
# operands at STEP0_REL (`block_operand_check`: each block's backward
# taken again unrouted on the routed run's input and cotangent, read
# 3.6e-6 at worst on an H100), and each bf16 `mmad` call of its first
# routed step, forward, recompute and backward, to the plain version on
# its own operands (`OperandCheck`).
FP32_HELD_TRAIN = ("xlstm-1.3b",)
# deepseek-v2-236b serves at full width, SERVE_V2_LAYERS deep (1 dense + 5
# MoE layers, 21.2 B parameters, 42.5 GB of bf16; the full 60 layers are
# ~472 GB). MLA's naive form against its absorbed form, relative L2 of the
# last prompt position's logits: the same function with bf16 roundings at
# other points (K up-projected and rounded, against the query absorbed and
# rounded) and other kernels (the tensor-core tile at M = 128 against the
# stream kernels at M = 4), through 6 layers of random weights; the
# routed-vs-unrouted bound above.
SERVE_V2_LAYERS = 6
# deepseek-v2-236b trains at full width, V2_TRAIN_LAYERS deep: layer 0
# alone (MLA + the dense FFN, 1.39 B parameters with embed and lm_head). Two
# layers (+ 1 MoE layer of 160 experts, 5.36 B) hold 64 GB of parameters,
# gradients and fp32 AdamW moments before activations and temporaries, and
# ran out of the card's memory after a peak of 82.56 GB; one layer peaked
# at 34.16 GB (`tools/train_lr_probe.py --arch deepseek-v2-236b --layers 2`
# and `--layers 1`, routed, on an H100). The MoE layer's training on the
# card is deepseek-moe-16b's phase. At TRAIN_LR its loss went 12.20 ->
# 17.85 -> 11.42 -> 9.98 over the three steps (routed; at 1e-3 it ended at
# 13.50).
V2_TRAIN_LAYERS = 1
NAIVE_ABSORBED_REL_L2 = FIRST_STEP_REL_L2
# The recurrent stacks' chunked forward against their recurrent decode,
# relative L2 of the logits over every position of CHECK_BATCH x CHECK_SEQ
# tokens (two chunks of `ssm.CHUNK`): the same function with its scans
# summed in other orders; the MLA check's bound. It and the recurrent
# stacks' first-step check are held in fp32, on the same weights cast up,
# and printed in bf16 beside: a random stack amplifies its rounding noise
# layer by layer. xlstm-1.3b's first decode step with bf16 `x @ w` against
# fp32-summed GEMMs rounded to bf16 read rel L2 2.9e-2 at 8 of its 48
# layers, 0.18 at 16 and 0.27 at 24 (`tools/bf16_sensitivity.py` on the
# CPU), and its routed step against the unrouted one 0.71 at all 48 on an
# H100: no bf16 limit tells a fault from that noise. In fp32 the same gain
# acts on 2^-24 roundings (xlstm read 5.6e-4 on the first step and 2.4e-2
# over 2 x 256 tokens on an H100). The bf16 kernels are held instead on
# their own operands: every `mmad` call of the bf16 routed step and of the
# bf16 chunked forward against the plain version on the same tensors
# (`OperandCheck`), strided views included.
CHECK_BATCH, CHECK_SEQ = 2, 256
CHUNKED_RECURRENT_REL_L2 = FIRST_STEP_REL_L2
# The frontend models' forward checks, relative L2 of the logits, held in
# bf16: seamless-m4t-medium's routed forward (the encoder over BATCH x 960
# frames, the decoder over the prompt) against its routed decode of the
# prompt on that forward's encoder output, at every prompt position; and
# phi-3-vision-4.2b's routed forward of BATCH x 576 patch embeddings and
# the prompt against the unrouted one. Unlike the recurrent stacks, these
# random stacks barely amplify bf16 rounding: with every GEMM as bf16
# `x @ w` against fp32 sums rounded to bf16, the full-depth forward's
# logits read rel L2 1.10e-2 (seamless, 12 + 12 layers) and 2.05e-2
# (phi-3-vision, 32 layers), gemma-2b's 1.70e-2, on an H100
# (`tools/bf16_sensitivity.py --forward`); so the routed-vs-unrouted bound
# above holds them, 4.5x and 2.4x those readings, where a wrong path reads
# near 1.
ENCODER_DECODE_REL_L2 = PREFIX_FORWARD_REL_L2 = FIRST_STEP_REL_L2
FRONTEND_SCALE = 0.02       # random patch / frame embeddings, as serve's


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f}s)", flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def wall_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around `iters` calls:
    device time when the card is the bottleneck, the host's pace when the
    host is (small calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Edges of a profiled window. On an H100 (torch 2.11, cu128) a device-only
# window of 32 decode steps, synchronized at both ends, does not always
# hold every kernel the card ran in it: in 5 of 8 windows the profile lost
# some of the first ones, from 2 to 1,317 of 51,168, mmad among them
# (tools/profile_edge_probe.py). So the counted work starts after a host
# pause and a run of spin kernels that absorb the loss, and ends before
# another such run and pause; a window that lost all of its leading or
# trailing spin kernels fails rather than count short.
PROFILE_EDGE_S, PROFILE_EDGE_KERNELS = 0.25, 1000
SPIN_KERNEL = "spin_kernel"             # what torch.cuda._sleep launches


@contextlib.contextmanager
def device_profile(torch, dev, host: bool = False):
    """A device-only (`host`: and host-activity) `torch.profiler` window
    around the block's work, with `PROFILE_EDGE_S` of host pause and
    `PROFILE_EDGE_KERNELS` spin kernels at each edge; yields the profiler.
    `device_kernels` leaves the spin kernels out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_EDGE_S)
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        yield prof
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)
        time.sleep(PROFILE_EDGE_S)


def edge_counts(torch, prof) -> tuple[int, int] | None:
    """How many of a `device_profile` window's leading and trailing spin
    kernels the profile holds; None when it holds no device work."""
    from torch.autograd import DeviceType
    names = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.name.startswith("dit_gemm.")),
        key=lambda e: e.time_range.start)]
    work = [i for i, name in enumerate(names) if SPIN_KERNEL not in name]
    if not work:
        return None
    return work[0], len(names) - 1 - work[-1]


def edge_kernels_kept(torch, prof) -> tuple[int, int]:
    """`edge_counts`, failing if the profile holds no device work or none
    of the spin kernels at either edge: the profile may then have lost
    counted work too."""
    edges = edge_counts(torch, prof)
    if edges is None:
        fail("the profiled window holds no device work")
    lead, trail = edges
    if not (lead and trail):
        fail(f"the profiled window kept {lead} leading and {trail} trailing "
             f"of its {PROFILE_EDGE_KERNELS} edge kernels")
    return lead, trail


def device_kernels(torch, prof):
    """(self device us, calls, name) of each kernel in a profile. Only the
    device-side events count: a CPU op's own device time is the same
    kernels again, and so is a `record_function` span on the device
    timeline (`dit_gemm.<mode>`); `device_profile`'s edge kernels are
    not the window's work."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("dit_gemm.")
                   and SPIN_KERNEL not in e.key), reverse=True)


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn`: CUDA events around `iters`
    calls that the host queues behind a spin kernel, so the card runs them
    back to back and host time between launches does not count. Fails if
    the host could not queue them all before the spin ended."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000                 # ~25 ms at the H100's boost clock
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("could not queue the timed calls ahead of the card")


def tensor_core_atol(k: int) -> float:
    """The tensor-core variant's extra absolute error on unit-normal inputs.
    Its products are exact, but the tensor cores add each 16-deep K slice
    into the fp32 accumulator with truncation, not IEEE round-to-nearest:
    up to one ulp (2^-23 relative) of the running sum at each of K/16
    steps, and a running sum stays within 4 sqrt(K) (four standard
    deviations). On an H100 the largest error against the IEEE plain
    version read 9.6e-4 at K = 2048 and 1.43e-2 at K = 16384, 5.0x the
    IEEE bound there (tools/mmad_train_times.py); this bound is 2.9x and
    4.4x those readings. The SIMT kernels are never given it."""
    return 2.0 ** -23 * (k / 16) * 4 * math.sqrt(k)


def tolerance_ratio(torch, got, want, k: int, out_dtype,
                    tensor_cores: bool = False) -> float:
    """Largest |kernel - plain| over its tolerance (fails above 1): rtol
    1e-5 and atol 1e-5*sqrt(K) for fp32 sums of fp32-exact products taken
    in another order, plus one output ulp for bf16 / fp16 out, plus
    `tensor_core_atol` for the tensor-core variant."""
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        out_dtype, 0.0)
    err = (got.float() - want.float()).abs()
    tol = (1e-5 * math.sqrt(k) + (tensor_core_atol(k) if tensor_cores else 0)
           + (1e-5 + ulp) * want.float().abs())
    return float((err / tol).max())


def check_kernels(torch, mmad_mod, ref) -> float:
    """Kernel vs plain version over dtypes and geometries, through the
    `mmad` wrapper; returns the largest error seen relative to its
    tolerance (must be <= 1)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    dtypes = [torch.float32, torch.bfloat16, torch.float16,
              torch.float8_e4m3fn, torch.int8]
    cases = [
        # (m, k, n, block, transpose_b); the first five are the main path's
        # decode GEMMs at the plan's block geometry
        (4, 2048, 2048, (4, 128, 256), False),      # q, o
        (4, 2048, 256, (4, 256, 128), False),       # k, v
        (4, 2048, 16384, (4, 512, 256), False),     # gate, up
        (4, 16384, 2048, (4, 128, 512), False),     # down
        (4, 2048, 256000, (4, 512, 256), True),     # lm_head: embed.T, unsplit
        (4, 2048, 256, (4, 512, 256), True),        # column stream, split K
        (4, 512, 270336, (4, 512, 256), False),     # row stream, no fixup
        (4, 2048, 64, (4, 256, 64), False),         # deepseek's fp32 router
        (2, 512, 384, (2, 128, 128), False),        # bm = 2
        (48, 120, 192, (24, 96, 40), False),        # tile: non-power-of-two
        (5, 130, 7, (8, 128, 128), False),          # tile: ragged
        (200, 300, 260, (128, 128, 128), True),     # tile: strided B
    ]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reached = set()
    worst = 0.0
    for dt in dtypes:
        for m, k, n, block, tb in cases:
            def draw(shape):
                if dt == torch.int8:
                    return torch.randint(-8, 9, shape, generator=g,
                                         device=dev).to(dt)
                return torch.randn(shape, generator=g, device=dev).to(dt)
            a = draw((m, k))
            b = draw((n, k)).T if tb else draw((k, n))
            variant, _, splits = mmad_mod.plan_launch(
                m, n, k, block, n_sms, mmad_mod.b_layout(b), b.element_size(),
                mmad_mod.wgmma_b_major(a, b))
            reached.add((variant, splits == 1))
            outs = ((torch.float32, torch.bfloat16) if dt == torch.bfloat16
                    else (torch.float32,))
            for out_dtype in outs:
                got = mmad_mod.mmad(a, b, block, out_dtype)
                want = ref.mmad_ref(a, b, out_dtype)
                torch.cuda.synchronize()
                ratio = tolerance_ratio(torch, got, want, k, out_dtype,
                                        variant == mmad_mod.WGMMA)
                worst = max(worst, ratio)
                if not ratio <= 1.0:
                    fail(f"mmad {dt} m={m} k={k} n={n} block={block} "
                         f"transposed={tb} out={out_dtype} variant={variant} "
                         f"splits={splits}: max abs err "
                         f"{float((got.float() - want.float()).abs().max()):.3e}"
                         f" exceeds tolerance (ratio {ratio:.2f})")
            del a, b, got, want
    # every variant, and both ways each stream kernel writes C: directly,
    # or through split-K partials that its last split sums in the same launch
    need = {(v, unsplit) for v in (mmad_mod.ROW_STREAM, mmad_mod.COL_STREAM)
            for unsplit in (False, True)}
    tiles = {mmad_mod.TILE, mmad_mod.WGMMA}
    if not need <= reached or not tiles <= {v for v, _ in reached}:
        fail(f"kernel variants reached {sorted(reached)}, need {sorted(need)} "
             f"and both tile kernels (variants {sorted(tiles)})")
    print(f"mmad vs plain: {len(dtypes)} dtypes x {len(cases)} geometries "
          f"agree (worst err/tol {worst:.3f}; rtol 1e-5, atol 1e-5*sqrt(K), "
          f"+1 ulp for bf16 out, + the tensor-core term on that variant); "
          f"(variant, unsplit) reached: {sorted(reached)}", flush=True)
    # the train path's GEMMs: bf16 at the plan's block geometry, all on the
    # tensor-core kernel, each launched three times (a ring slot freed too
    # early would show as launches that disagree)
    tc_worst = 0.0
    for m, k, n, block, tb in TRAIN_CASES:
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn((n, k), generator=g, device=dev).to(torch.bfloat16).T
             if tb else torch.randn((k, n), generator=g,
                                    device=dev).to(torch.bfloat16))
        variant, _, splits = mmad_mod.plan_launch(
            m, n, k, block, n_sms, mmad_mod.b_layout(b), b.element_size(),
            mmad_mod.wgmma_b_major(a, b))
        if variant != mmad_mod.WGMMA:
            fail(f"train shape {m}x{n}x{k} would not run the tensor-core "
                 f"kernel (variant {variant})")
        for out_dtype in (torch.float32, torch.bfloat16):
            got = mmad_mod.mmad(a, b, block, out_dtype)
            want = ref.mmad_ref(a, b, out_dtype)
            torch.cuda.synchronize()
            ratio = tolerance_ratio(torch, got, want, k, out_dtype, True)
            ieee = tolerance_ratio(torch, got, want, k, out_dtype)
            tc_worst = max(tc_worst, ieee)
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                fail(f"mmad train shape {m}x{n}x{k} transposed={tb} "
                     f"out={out_dtype} splits={splits}: error {ratio:.2f}x "
                     f"its tolerance")
            for _ in range(2):
                if not torch.equal(mmad_mod.mmad(a, b, block, out_dtype),
                                   got):
                    fail(f"mmad train shape {m}x{n}x{k} transposed={tb}: "
                         f"two launches disagree")
        # the backward's products on the same operands, as views:
        # da = g @ b.T (b.T K-contiguous; lm_head's is embed, N-contiguous)
        # and db = a.T @ g (a.T M-contiguous)
        grad = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
        for x, y, name in ((grad, b.T, "da"), (a.T, grad, "db")):
            variant = mmad_mod.plan_launch(
                x.shape[0], y.shape[1], x.shape[1], block, n_sms,
                mmad_mod.b_layout(y), 2, mmad_mod.wgmma_b_major(x, y))[0]
            if variant != mmad_mod.WGMMA:
                fail(f"backward {name} of train shape {m}x{n}x{k} would not "
                     f"run the tensor-core kernel (variant {variant})")
            got = mmad_mod.mmad(x, y, block, torch.float32)
            want = ref.mmad_ref(x, y, torch.float32)
            torch.cuda.synchronize()
            ratio = tolerance_ratio(torch, got, want, x.shape[1],
                                    torch.float32, True)
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                fail(f"mmad backward {name} of train shape {m}x{n}x{k}: "
                     f"error {ratio:.2f}x its tolerance")
            if not torch.equal(mmad_mod.mmad(x, y, block, torch.float32),
                               got):
                fail(f"mmad backward {name} of train shape {m}x{n}x{k}: "
                     f"two launches disagree")
            del got, want
        del a, b, grad
    print(f"mmad vs plain at the {len(TRAIN_CASES)} train shapes and their "
          f"backward's two products (bf16 in, fp32 and bf16 out, "
          f"tensor-core kernel, repeated launches bitwise equal): agree "
          f"(worst err/tol so far {worst:.3f}; the forward against the IEEE "
          f"bound alone {tc_worst:.3f})", flush=True)
    return worst


def shape_operands(torch, mmad_mod, ref, cfg, m, n, k, block, dtype, g, dev,
                   copies: int = 1):
    """A GEMM shape's operands as its path lays them out (an activation
    (m, k); `copies` weights (k, n), N-contiguous, or lm_head's embed.T
    when the embeddings are tied), and the kernel held to its plain
    version on the first at the plan's `block`, at the tolerance of the
    variant `plan_launch` picks. Returns (a, weights, variant, max abs
    err, err over tolerance)."""
    size = torch.finfo(dtype).bits // 8
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    if cfg.tie_embeddings and n == cfg.vocab:       # lm_head: embed.T, a view
        ws = [torch.randn((n, k), generator=g, device=dev).to(dtype).T
              for _ in range(copies)]
    else:
        ws = [torch.randn((k, n), generator=g, device=dev).to(dtype)
              for _ in range(copies)]
    variant = mmad_mod.plan_launch(
        m, n, k, block,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        mmad_mod.b_layout(ws[0]), size, mmad_mod.wgmma_b_major(a, ws[0]))[0]
    got = mmad_mod.mmad(a, ws[0], block, torch.float32)
    want = ref.mmad_ref(a, ws[0], torch.float32)
    ratio = tolerance_ratio(torch, got, want, k, torch.float32,
                            variant == mmad_mod.WGMMA)
    if not ratio <= 1.0:
        fail(f"mmad at shape {m}x{n}x{k} ({dtype}, block {block}, variant "
             f"{variant}): error {ratio:.2f}x its tolerance")
    return a, ws, variant, float((got - want).abs().max()), ratio


def hold_shapes(torch, mmad_mod, ref, cfg, table, dev, seed: int) -> float:
    """Every shape of `table` (as `launch_table` gives it) held once to
    its plain version at the plan's block; returns the worst error over
    its tolerance."""
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for (m, n, k, _), info in sorted(table.items()):
        a, ws, _, _, ratio = shape_operands(torch, mmad_mod, ref, cfg, m, n,
                                            k, info["block"], info["dtype"],
                                            g, dev)
        worst = max(worst, ratio)
        del a, ws
    torch.cuda.empty_cache()
    return worst


def time_shapes(torch, mmad_mod, ref, cfg, table, dev, seed: int,
                kind: str = "decode"):
    """Per GEMM shape of one step (`table`: (m, n, k[, dtype]) -> the
    plan's block, the launches per step and the operand dtype): the
    kernel's device time, held to its tolerance again, beside the plain
    version's, one `torch.matmul` call's (cuBLAS in the operands' dtype),
    the bound and the roofline share, at the plan's block
    geometry. Weights rotate through enough copies to exceed the 50 MB L2,
    as a step's do. Decode rows add the host's pace per kernel call; train
    rows add the TFLOPS and the backward's two `mmad` products (da = g @
    b.T and db = a.T @ g on the views `backward_products` passes, run once
    per forward dispatch: the table's `backward_calls`), held to their
    tolerance, beside their plain version, bf16 `torch.matmul` and their
    bound. `kind` ("decode", "train" or "forward") names the path in each
    row; "train" adds the backward."""
    g = torch.Generator(device=dev).manual_seed(seed)
    train = kind == "train"
    rows = []
    for key, info in sorted(table.items()):
        (m, n, k), block, count = key[:3], info["block"], info["count"]
        dtype = info.get("dtype", torch.bfloat16)   # the router's is fp32
        size = torch.finfo(dtype).bits // 8
        copies = max(1, math.ceil(120e6 / (k * n * size)))
        a, ws, variant, err, ratio = shape_operands(
            torch, mmad_mod, ref, cfg, m, n, k, block, dtype, g, dev, copies)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % copies
            return ws[it["i"]]

        iters, warmup = (5, 1) if m * n * k > 1e11 else (20, 3)

        def timed(fn):
            return device_ms(torch, fn, iters=iters, warmup=warmup)

        kernel_ms = timed(lambda: mmad_mod.mmad(a, nxt(), block,
                                                torch.float32))
        flops = 2 * m * n * k
        t_bytes = ((m * k + k * n) * size + m * n * 4) / H100_BYTES_PER_S * 1e3
        t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32
                         else H100_BF16_FLOPS) * 1e3
        row = {"path": f"{cfg.name} {kind}",
               "shape": [m, n, k], "dtype": str(dtype).split(".")[-1],
               "block": list(block), "variant": variant,
               "launches_per_step": count,
               "kernel_ms": kernel_ms,
               "plain_ms": timed(lambda: ref.mmad_ref(a, nxt(),
                                                      torch.float32)),
               "library_ms": timed(lambda: torch.matmul(a, nxt())),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "roofline_share": max(t_bytes, t_ops) / kernel_ms,
               "max_abs_err": err, "err_over_tolerance": ratio}
        if train:
            row["kernel_tflops"] = flops / kernel_ms / 1e9
            row["backward_calls_per_step"] = info["backward_calls"]
            if dtype == torch.float32:      # the router: torch.matmul's
                row.update(time_fp32_backward(torch, a, ws[0], nxt, g, timed))
                row["fp32_backward_calls_per_step"] = info[
                    "fp32_backward_calls"]
            else:
                row.update(time_backward(torch, mmad_mod, ref, a, ws[0], nxt,
                                         block, g, timed))
        else:
            row["kernel_call_wall_ms"] = wall_ms(
                torch, lambda: mmad_mod.mmad(a, nxt(), block, torch.float32))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, ws
    torch.cuda.empty_cache()
    return rows


def time_backward(torch, mmad_mod, ref, a, w, nxt, block, g, timed):
    """The backward of one train GEMM (a @ w) as `backward_products` runs
    it: da = grad @ w.T and db = a.T @ grad on `mmad`, on views, with a
    bf16 gradient; its error against the plain version at `w`, then the
    device time of both products (weights rotating through `nxt`) beside
    the plain version's, bf16 `torch.matmul`'s and their bound."""
    from repro_torch.kernels.ops import padded_rows

    m, k = a.shape
    n = w.shape[1]
    # laid out as `backward_products` lays g out (rows padded to whole 16
    # bytes where N needs it)
    grad = padded_rows(torch.randn((m, n), generator=g, device=a.device),
                       torch.bfloat16)
    err = ratio = 0.0
    for x, y in ((grad, w.T), (a.T, grad)):
        variant = mmad_mod.plan_launch(
            x.shape[0], y.shape[1], x.shape[1], block,
            torch.cuda.get_device_properties(a.device).multi_processor_count,
            mmad_mod.b_layout(y), 2, mmad_mod.wgmma_b_major(x, y))[0]
        got = mmad_mod.mmad(x, y, block, torch.float32)
        want = ref.mmad_ref(x, y, torch.float32)
        ratio = max(ratio, tolerance_ratio(torch, got, want, x.shape[1],
                                           torch.float32,
                                           variant == mmad_mod.WGMMA))
        err = max(err, float((got - want).abs().max()))
        del got, want
    if not ratio <= 1.0:
        fail(f"mmad backward of {m}x{n}x{k}: error {ratio:.2f}x its "
             f"tolerance")

    def products(fn):
        def run():
            y = nxt()
            return fn(grad, y.T), fn(a.T, grad)
        return run

    bound, by_bytes = 0.0, True
    for mm, nn, kk in ((m, k, n), (k, n, m)):       # da, db
        t_bytes = (mm * kk * 2 + kk * nn * 2 + mm * nn * 4) / H100_BYTES_PER_S
        t_ops = 2 * mm * nn * kk / H100_BF16_FLOPS
        bound += max(t_bytes, t_ops) * 1e3
        by_bytes = by_bytes and t_bytes >= t_ops
    out = {
        "backward_ms": timed(products(lambda x, y: mmad_mod.mmad(
            x, y, block, torch.float32))),
        "backward_plain_ms": timed(products(lambda x, y: ref.mmad_ref(
            x, y, torch.float32))),
        "backward_library_ms": timed(products(torch.matmul)),
        "backward_bound_ms": bound,
        "backward_bound_by": "bytes" if by_bytes else "operations",
        "backward_max_abs_err": err, "backward_err_over_tolerance": ratio}
    del grad
    return out


def time_fp32_backward(torch, a, w, nxt, g, timed):
    """The backward of an fp32 train GEMM (the MoE router, a @ w) as
    `_LocalMatmul` runs it: da = grad @ w.T and db = a.T @ grad as two fp32
    `torch.matmul` calls (IEEE, TF32 off), device time and bound."""
    m, k = a.shape
    n = w.shape[1]
    grad = torch.randn((m, n), generator=g, device=a.device)

    def run():
        y = nxt()
        return torch.matmul(grad, y.T), torch.matmul(a.T, grad)

    bound, by_bytes = 0.0, True
    for mm, nn, kk in ((m, k, n), (k, n, m)):       # da, db
        t_bytes = (mm * kk + kk * nn + mm * nn) * 4 / H100_BYTES_PER_S
        t_ops = 2 * mm * nn * kk / H100_FP32_FLOPS
        bound += max(t_bytes, t_ops) * 1e3
        by_bytes = by_bytes and t_bytes >= t_ops
    out = {"fp32_backward_matmul_ms": timed(run),
           "fp32_backward_bound_ms": bound,
           "fp32_backward_bound_by": "bytes" if by_bytes else "operations"}
    del grad
    return out


def busy_share(torch, params, cfg, planner, prompts, dev,
               unprofiled_step_ms: float, gemms_per_step: int,
               tensor_core_per_step: int = 0, encoder_out=None) -> dict:
    """Device busy time and wall time per decode step, both read from one
    window: the main run's batch, prompts and positions (prefill token by
    token through a fresh routed context, then its GEN decode steps under
    the profiler, the wall clock read inside the profiled window; an
    encoder-decoder's steps attend to `encoder_out`). Only device activity
    is traced: tracing every host op would slow the host, and with it the
    window, severalfold. Fails unless each of the step's `gemms_per_step`
    mmad calls ran as one kernel, `tensor_core_per_step` of them the
    tensor-core kernel (by name; the rest the stream kernels), and none as
    the tile kernel's separate split-K reduce. Returns per step the busy,
    wall and `mmad` ms and the tensor-core launches."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init
    from repro_torch.train.steps import make_serve_step

    step = make_serve_step(cfg)
    # a window whose profile lost its edge kernels (seen on the card: all
    # 1000 trailing ones of one deepseek-moe-16b window) is run again from
    # a fresh prefill, up to REPLAY_ATTEMPTS windows; only a window that
    # kept both edges is counted
    for attempt in range(REPLAY_ATTEMPTS):
        serve.install_gemm_context(planner, dev)
        with torch.inference_mode():
            caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
            for i in range(PROMPT):
                logits, caches = step(params, caches, prompts[:, i:i + 1], i,
                                      encoder_out)
            tok = torch.argmax(logits, -1)[:, None]
            with device_profile(torch, dev) as prof:
                t0 = time.perf_counter()
                for i in range(GEN):
                    logits, caches = step(params, caches, tok, PROMPT + i,
                                          encoder_out)
                    tok = torch.argmax(logits, -1)[:, None]
                serve._sync(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3 / GEN
        shard_ctx.set_gemm_context(None)
        edges = edge_counts(torch, prof)
        if (edges and all(edges)) or attempt == REPLAY_ATTEMPTS - 1:
            break
        del caches
        print(f"{cfg.name} decode window: the profile kept {edges} of its "
              f"edge kernels; running it again", flush=True)
    edges = edge_kernels_kept(torch, prof)
    kernels = device_kernels(torch, prof)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3 / GEN
    reduce = [name for _, _, name in kernels if "mmad_splitk_reduce" in name]
    if reduce:
        fail(f"the decode window launched {reduce}")
    mmad_calls = sum(count for _, count, name in kernels if "mmad" in name)
    if mmad_calls != gemms_per_step * GEN:
        fail(f"{mmad_calls} mmad kernels ran in {GEN} decode steps of "
             f"{gemms_per_step} routed GEMMs")
    tensor_core = sum(count for _, count, name in kernels
                      if TENSOR_CORE_KERNEL in name)
    if tensor_core != tensor_core_per_step * GEN:
        fail(f"{tensor_core} tensor-core mmad kernels ran in {GEN} decode "
             f"steps, not {tensor_core_per_step} a step")
    mmad_ms = sum(us for us, _, name in kernels if "mmad" in name) / 1e3 / GEN
    for us, count, name in kernels[:10]:
        print(f"  device {us / 1e3 / GEN:8.3f} ms/step  {count / GEN:7.1f} "
              f"calls/step  {name[:80]}", flush=True)
    print(f"profiled window of {GEN} {cfg.name} decode steps (batch {BATCH}, "
          f"positions {PROMPT}-{PROMPT + GEN - 1}): device busy {busy_ms:.3f} "
          f"ms per step ({mmad_ms:.3f} ms in mmad: "
          f"{gemms_per_step - tensor_core_per_step} stream and "
          f"{tensor_core_per_step} tensor-core kernels a step) against "
          f"{wall_ms:.3f} ms "
          f"per step wall in the same window: "
          f"busy share {busy_ms / wall_ms:.1%}; the rest is host time between "
          f"launches (the unprofiled main run took {unprofiled_step_ms:.3f} "
          f"ms per step); the profile kept {edges[0]} + {edges[1]} of its 2 x "
          f"{PROFILE_EDGE_KERNELS} edge kernels", flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "mmad_ms": mmad_ms,
            "tensor_core_per_step": tensor_core / GEN}


class OperandCheck:
    """Holds every `mmad` call made while `watching` to the plain version on
    the same operands (views as the path passes them), at the tolerance of
    the variant `plan_launch` picks; keeps the calls, the worst error over
    tolerance, and per (m, n, k, operand dtype) the calls and how many of
    them took the tensor-core kernel. The plain products do not launch
    `mmad`."""

    def __init__(self, torch, mmad_mod):
        self.torch, self.mmad_mod = torch, mmad_mod
        self.calls, self.worst = 0, 0.0
        self.shapes = {}

    @contextlib.contextmanager
    def watching(self):
        from repro_torch.kernels import ops, ref
        torch, mmad_mod = self.torch, self.mmad_mod
        real = ops.mmad

        def checked(a, b, block_shape=(128, 128, 128), out_dtype=None):
            out = real(a, b, block_shape, out_dtype)
            tensor_cores = a.is_cuda and mmad_mod.plan_launch(
                a.shape[0], b.shape[1], a.shape[1], block_shape,
                mmad_mod._num_sms(a.device), mmad_mod.b_layout(b),
                b.element_size(),
                mmad_mod.wgmma_b_major(a, b))[0] == mmad_mod.WGMMA
            want = ref.mmad_ref(a, b, out_dtype or a.dtype)
            self.worst = max(self.worst, tolerance_ratio(
                torch, out, want, a.shape[1], out_dtype or a.dtype,
                tensor_cores))
            self.calls += 1
            rec = self.shapes.setdefault(
                (a.shape[0], b.shape[1], a.shape[1], str(a.dtype)),
                {"calls": 0, "tensor_core": 0, "dtype": a.dtype})
            rec["calls"] += 1
            rec["tensor_core"] += int(tensor_cores)
            return out

        ops.mmad = checked
        try:
            yield self
        finally:
            ops.mmad = real


def fp32_copy(torch, cfg, params):
    """The config and weights in fp32 (the same values, cast up)."""
    from repro_torch.models.model import init_params
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = init_params(None, cfg32, device="meta")
    params32.load_state_dict({k: v.float() for k, v in
                              params.state_dict().items()}, assign=True)
    return cfg32, params32


def first_steps(torch, params, cfg, planner, prompts, dev, operands=None,
                encoder_out=None):
    """The first decode step unrouted (no context: x @ w), then routed, its
    `mmad` calls held by `operands` when given (an encoder-decoder's both
    on `encoder_out`): (routed, unrouted) logits."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init, decode_step

    with torch.inference_mode():
        try:
            shard_ctx.set_gemm_context(None)
            caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
            plain, _ = decode_step(params, caches, prompts[:, :1], 0, cfg,
                                   encoder_out)
            serve.install_gemm_context(planner, dev)
            caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
            with (operands.watching() if operands
                  else contextlib.nullcontext()):
                routed, _ = decode_step(params, caches, prompts[:, :1], 0,
                                        cfg, encoder_out)
        finally:
            shard_ctx.set_gemm_context(None)
    return routed, plain


def tag_layers(cfg, tag: str) -> int:
    """How many times a decode step dispatches the GEMM of `tag`: once per
    layer that has it (attention in every layer, the dense MLP in the dense
    layers, the router and shared experts in the MoE layers; zamba2's
    Mamba2 projections in every layer and the shared block's attention and
    MLP once per super-layer; xLSTM's mLSTM and sLSTM projections in their
    layers; an encoder-decoder's decoder layers run `attn.q` and `attn.o`
    twice at one shape, self- and cross-attention, and `attn.k` and
    `attn.v` once at each of two, the token's rows and the encoder's),
    lm_head once."""
    if tag == "lm_head":
        return 1
    if cfg.is_encoder_decoder and tag in ("attn.q", "attn.o"):
        return 2 * cfg.n_layers
    if cfg.block_pattern == "mamba2_hybrid":
        return (cfg.n_layers if tag.startswith("mamba.")
                else cfg.n_layers // cfg.hybrid_attn_every)
    if cfg.block_pattern == "xlstm":
        n_super = cfg.n_layers // cfg.slstm_every
        return n_super if tag.startswith("slstm.") else cfg.n_layers - n_super
    moe_layers = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    if tag.startswith("moe."):
        return moe_layers
    if tag.startswith("mlp."):
        return cfg.n_layers - moe_layers
    return cfg.n_layers


def routing_census(torch, params, cfg, planner, prompts, dev):
    """The MoE first decode step three ways, each layer's top-k choice
    recorded: routed (router on `mmad` in fp32), unrouted with its own
    choices (router `x @ w`), and unrouted with the routed run's choices
    pinned (gates still its own). Returns the routed and pinned logits, and
    counts over token-layers: choices that differ between the routed and
    free unrouted runs, and choices the two routers make differently on the
    same input (each routed layer's input also goes through `x @ w`)."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init, decode_step

    def first_step():
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        return decode_step(params, caches, prompts[:, :1], 0, cfg)[0]

    free, routed = ChoiceLog(torch), ChoiceLog(torch)
    with torch.inference_mode():
        try:
            shard_ctx.set_gemm_context(None)
            with free.recording():
                free_logits = first_step()
            serve.install_gemm_context(planner, dev)
            with routed.recording():
                routed_logits = first_step()
            shard_ctx.set_gemm_context(None)
            with routed.pinned():
                plain = first_step()
        finally:
            shard_ctx.set_gemm_context(None)
    if len(free.choices) != len(routed.choices):
        fail("the three first steps routed different numbers of MoE layers")
    flips = sum(choice_flips(a, b)
                for a, b in zip(routed.choices, free.choices))
    free_rel = float((routed_logits - free_logits).norm() / free_logits.norm())
    return routed_logits, plain, {
        "token_layers": routed.token_layers, "flips": flips,
        "same_input_flips": routed.same_input_flips(),
        "free_rel_l2": free_rel}


def state_spans(cfg) -> dict:
    """The profiler spans of a decode step's work outside `mmad` that
    `step_split` reads, each with the number of layers that open it once a
    step: the MoE layers' dispatch, expert and combine einsums; the Mamba2
    layers' conv and SSD; the mLSTM layers' C/n/m update and readout; the
    sLSTM layers' recurrence."""
    if cfg.block_pattern == "mamba2_hybrid":
        return {"mamba.state": cfg.n_layers}
    if cfg.block_pattern == "xlstm":
        n_super = cfg.n_layers // cfg.slstm_every
        return {"mlstm.state": cfg.n_layers - n_super, "slstm.state": n_super}
    if cfg.n_experts:
        return {"moe.einsums": cfg.n_layers - cfg.n_dense_layers}
    return {}


def span_key(name: str) -> str:
    """The summary key of a `state_spans` span's device ms per step."""
    return name.replace(".", "_") + "_ms"


def step_split(torch, params, cfg, planner, prompts, dev,
               gemms_per_step: int) -> dict:
    """Device time of one routed decode step (the first, on fresh caches)
    by where it goes: `mmad` kernels (by name), and the kernels launched
    inside each of `state_spans`' profiler spans (its device time summed
    over its ops' kernels). A device-only window holds no span ranges, so
    this step is traced with host activity too, which slows the host but
    not the kernels."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init, decode_step
    from torch.autograd import DeviceType

    serve.install_gemm_context(planner, dev)
    with torch.inference_mode():
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        decode_step(params, caches, prompts[:, :1], 0, cfg)     # warm
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        with device_profile(torch, dev, host=True) as prof:
            decode_step(params, caches, prompts[:, :1], 0, cfg)
    shard_ctx.set_gemm_context(None)
    edge_kernels_kept(torch, prof)
    events = prof.events()
    want = state_spans(cfg)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in want and SPIN_KERNEL not in e.name
               and not e.name.startswith("dit_gemm.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    mmad_ms = sum(e.time_range.elapsed_us() for e in kernels
                  if "mmad" in e.name) / 1e3
    mmad_calls = sum("mmad" in e.name for e in kernels)
    if mmad_calls != gemms_per_step:
        fail(f"{mmad_calls} mmad kernels ran in the traced step of "
             f"{gemms_per_step} routed GEMMs")
    out = {"step_busy_ms": busy_ms, "step_mmad_ms": mmad_ms}
    parts = []
    for name, layers in want.items():
        spans = [e for e in events if e.name == name
                 and e.device_type == DeviceType.CPU]
        if len(spans) != layers:
            fail(f"the traced step holds {len(spans)} {name!r} spans for "
                 f"{layers} layers")
        ms = sum(e.device_time_total for e in spans) / 1e3
        if not 0 < ms < busy_ms:
            fail(f"the device time {ms} ms of the {name!r} spans is not a "
                 f"part of the step's {busy_ms} ms")
        out[span_key(name)] = ms
        parts.append(f"{ms:.3f} ms in {name} ({len(spans)} spans)")
    rest = busy_ms - mmad_ms - sum(out[span_key(n)] for n in want)
    print(f"one traced {cfg.name} decode step (host activity traced too): "
          f"device busy {busy_ms:.3f} ms, of it {mmad_ms:.3f} ms in mmad, "
          f"{', '.join(parts)}, {rest:.3f} ms elsewhere", flush=True)
    return out


# the routed GEMMs whose operands are fp32: the MoE router and the mLSTM
# input and forget gates' pre-activations
FP32_TAGS = ("moe.router", "mlstm.gates")


def plan_block(planner, ctx, shape, elem_bytes: int):
    """The block geometry `mmad` runs `shape` at under its plan: the inner
    kernel's, or for a plan without one the block `local_matmul` picks
    (`block_for`, the one rule for both)."""
    from repro_torch.core.lower import lower_schedule
    from repro_torch.kernels.ops import block_for

    ep = lower_schedule(planner.plan_cached(shape).schedule, ctx.mesh,
                        shape=shape)
    return block_for(ep.inner_kernel, shape.m, shape.n, shape.k, elem_bytes)


def launch_table(torch, cfg, planner, ctx) -> dict:
    """What one decode step, or one forward, of `ctx`'s run launches, per
    shape, at the plan's block geometry: (m, n, k, dtype) -> the block, the
    launches (each routed GEMM once per layer that has it, lm_head once)
    and the operand dtype (the router's and the mLSTM gates' fp32). The
    expert einsums are recorded, not dispatched, and attention is not a
    GEMM here."""
    table = {}
    for tag, shape in ctx.resolved:
        if not hasattr(shape, "m"):             # attention
            continue
        dtype = torch.float32 if tag in FP32_TAGS else cfg.dtype
        key = (shape.m, shape.n, shape.k, str(dtype))
        rec = table.setdefault(key, {
            "block": plan_block(planner, ctx, shape, dtype.itemsize),
            "count": 0, "dtype": dtype})
        rec["count"] += tag_layers(cfg, tag)
    return table


def calls_table(planner, ctx, calls) -> dict:
    """What a run watched by an `OperandCheck` launched, per shape (its
    `shapes`), laid out as `launch_table`'s, each shape at its plan's
    block geometry."""
    shapes = {(s.m, s.n, s.k): s for _, s in ctx.resolved if hasattr(s, "m")}
    return {key: {"block": plan_block(planner, ctx, shapes[key[:3]],
                                      rec["dtype"].itemsize),
                  "count": rec["calls"], "dtype": rec["dtype"]}
            for key, rec in calls.items()}


def serve_model(torch, mmad_mod, cfg, dev, after=None):
    """One serve phase at full width (and the depth `cfg` gives): the first
    decode step routed against unrouted; then the main path,
    `serve.generate` on a fresh routed context with the launch count from
    zero, its run report and assertions; then the device profile of the
    same decode steps; then `after(params, planner, prompts)`, when given,
    on the same weights. An encoder-decoder's every step attends to the
    launcher's stand-in encoder output (`serve.encoder_output`). Returns
    the launches, the per-step launch table per shape, and the numbers the
    report prints."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params
    from repro_torch.obs import render_run_report

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         dev)
    serve._sync(dev)
    print(f"{cfg.name}: {sum(p.numel() for p in params.parameters())} "
          f"parameters ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    plan_dir = ROOT / "build" / "chip_smoke" / "plan_cache" / cfg.name
    shutil.rmtree(plan_dir, ignore_errors=True)
    t0 = time.perf_counter()
    planner = serve.warm_plan_cache(cfg, BATCH, PROMPT, PROMPT + GEN,
                                    str(plan_dir), (4, 4), 12)
    warm_s = time.perf_counter() - t0
    print(f"plan warm-up for {cfg.name}: {warm_s:.2f}s", flush=True)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=gen).to(dev)
    encoder_out = None
    if cfg.is_encoder_decoder:
        import numpy as np
        encoder_out = serve.encoder_output(params, cfg, BATCH,
                                           np.random.default_rng(SEED), dev)

    # first decode step, unrouted (no context: x @ w) vs routed; an MoE
    # model's unrouted step takes the routed step's expert choices, and
    # the choices themselves are counted apart
    summary = {"warmup_s": warm_s}
    if cfg.n_experts:
        routed, plain, census = routing_census(torch, params, cfg, planner,
                                               prompts, dev)
        summary.update(census)
        print(f"first decode step, top-{cfg.moe_top_k} expert choices over "
              f"{census['token_layers']} token-layers: "
              f"{census['flips']} differ between the routed and the "
              f"unrouted run (limit {MOE_FLIP_SHARE:.0%} of them; free "
              f"unrouted logits rel L2 {census['free_rel_l2']:.3e}, not "
              f"held), {census['same_input_flips']} between the two "
              f"routers on the same input (limit {SAME_INPUT_FLIPS})",
              flush=True)
        if census["same_input_flips"] > SAME_INPUT_FLIPS:
            fail(f"the mmad router and x @ w chose different experts on the "
                 f"same input for {census['same_input_flips']} token-layers")
        if census["flips"] > MOE_FLIP_SHARE * census["token_layers"]:
            fail(f"{census['flips']} of {census['token_layers']} token-layers "
                 f"chose other experts routed than unrouted")
    recurrent = cfg.block_pattern != "attn"
    operands = OperandCheck(torch, mmad_mod)
    if not cfg.n_experts:
        routed, plain = first_steps(torch, params, cfg, planner, prompts, dev,
                                    operands if recurrent else None,
                                    encoder_out)
    rel = held = float((routed - plain).norm() / plain.norm())
    max_abs = float((routed - plain).abs().max())
    summary["first_step_rel_l2"] = rel
    print(f"first decode step, routed vs unrouted logits"
          f"{' (expert choices pinned)' if cfg.n_experts else ''}: rel L2 "
          f"{rel:.3e} ("
          f"{'in bf16, not held' if recurrent else f'tolerance {FIRST_STEP_REL_L2}'}"
          f"), max abs "
          f"{max_abs:.3e}, greedy tokens equal in "
          f"{int((routed.argmax(-1) == plain.argmax(-1)).sum())}/{BATCH} "
          f"rows", flush=True)
    if recurrent:
        cfg32, params32 = fp32_copy(torch, cfg, params)
        routed, plain = first_steps(torch, params32, cfg32, planner, prompts,
                                    dev)
        del params32
        held = float((routed - plain).norm() / plain.norm())
        summary["first_step_rel_l2_fp32"] = held
        summary["first_step_operands_err_over_tolerance"] = operands.worst
        print(f"  the same step on the weights in fp32: rel L2 {held:.3e} "
              f"(tolerance {FIRST_STEP_REL_L2}); the bf16 routed step's "
              f"{operands.calls} mmad calls against the plain version on "
              f"their own operands: worst err/tol {operands.worst:.3f}",
              flush=True)
        if not (operands.calls and operands.worst <= 1.0):
            fail(f"the routed first step's mmad calls differ from the plain "
                 f"version on their operands: {operands.worst:.2f}x the "
                 f"tolerance over {operands.calls} calls")
    if not held <= FIRST_STEP_REL_L2:
        fail(f"routed first-step logits differ from unrouted: rel L2 {held}")

    # the main path: a fresh routing context, counts from zero
    ctx = serve.install_gemm_context(planner, dev)
    mmad_mod.reset_launch_count()
    out = serve.generate(params, cfg, prompts, GEN, encoder_out=encoder_out)
    launches = mmad_mod.launch_count()
    stats = ctx.stats
    report = serve.build_serve_report(ctx, cfg, BATCH, PROMPT + GEN)
    for line in render_run_report(report):
        print(line, flush=True)
    shard_ctx.set_gemm_context(None)

    logits = out["logits"]
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    if tuple(logits.shape) != (BATCH, cfg.vocab):
        fail(f"logits shape {tuple(logits.shape)}")
    if stats.resolve_rate != 1.0:
        fail(f"plan-resolve rate {stats.resolve_rate}")
    if stats.silent_degrades:
        fail(f"{stats.silent_degrades} silent degrades")
    if launches == 0 or launches != stats.executed_gemm:
        fail(f"mmad launched {launches} times for "
             f"{stats.executed_gemm} routed GEMM dispatches")
    workload = report["workload"]
    if workload["covered"] != 1.0 or workload["extra"] or workload["missing"]:
        fail(f"the observed workload is not model_workload's: {workload}")
    steps = PROMPT + GEN
    per_step = launch_table(torch, cfg, planner, ctx)
    if sum(r["count"] for r in per_step.values()) * steps != launches:
        fail("per-step launch table does not add up to the launches")
    # past the stream kernels' rows, a bf16 GEMM takes the tensor cores:
    # an encoder-decoder's cross-attention K and V at the encoder's rows
    tensor_core = sum(r["count"] for (m, *_), r in per_step.items()
                      if m > mmad_mod.STREAM_MAX_M
                      and r["dtype"] in mmad_mod.WGMMA_DTYPES)
    summary.update(busy_share(torch, params, cfg, planner, prompts, dev,
                              out["t_gen"] / GEN * 1e3, launches // steps,
                              tensor_core, encoder_out))
    if state_spans(cfg):
        summary.update(step_split(torch, params, cfg, planner, prompts, dev,
                                  launches // steps))

    tok_s = BATCH * GEN / out["t_gen"]
    summary.update(tok_s=tok_s, step_ms=out["t_gen"] / GEN * 1e3)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(f"serve {cfg.name} on {card}: prefill "
          f"{PROMPT} tok in {out['t_prefill']:.3f}s, decode {GEN} tok in "
          f"{out['t_gen']:.3f}s = {tok_s:.1f} tok/s at batch {BATCH}; "
          f"{launches} mmad launches = {stats.executed_gemm} routed GEMM "
          f"dispatches ({tensor_core} a step on the tensor-core kernel), "
          f"resolve rate {stats.resolve_rate}", flush=True)
    print("sample generations:", out["tokens"][:2, :8].tolist(), flush=True)
    del encoder_out

    if dev.type == "cuda":
        summary["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{cfg.name} serve phase: peak device memory "
              f"{summary['peak_gb']:.2f} GB", flush=True)
    if after is not None:
        summary.update(after(params, planner, prompts))
    del params, planner
    return launches, per_step, summary


def naive_vs_absorbed(torch, mmad_mod, cfg, dev, params, planner, prompts):
    """MLA's two forms on the same weights: the routed absorbed decode of
    the prompt, token by token through the cache (each step's expert
    choices recorded), against one routed batched `forward` of the prompt,
    which runs the naive form (K and V up-projected, attention at dn + dr;
    its GEMMs at M = batch x prompt on the tensor-core kernel, each shape
    then held to the plain version at the plan's block), the decode's
    expert choices pinned token by token. The forward routes all
    the prompt's tokens at once, where a buffer of the one-hot dispatch can
    overflow and drop a token; a decode step at batch 4 cannot overflow
    one (4 tokens, at least 4 slots). So the forward's capacity is raised
    to hold every token, and both compute the same function: the last
    position's logits are held to NAIVE_ABSORBED_REL_L2."""
    import dataclasses
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import moe, shard_ctx
    from repro_torch.models.model import decode_init, decode_step, forward

    b, p = prompts.shape
    choices = ChoiceLog(torch)
    serve.install_gemm_context(planner, dev)
    with torch.inference_mode(), choices.recording():
        caches = decode_init(params, cfg, b, p)
        for i in range(p):
            absorbed, caches = decode_step(params, caches,
                                           prompts[:, i:i + 1], i, cfg)
    del caches
    layers = cfg.n_layers - cfg.n_dense_layers

    def by_layer(steps):
        # step i's MoE layer j routes (1, b, k); the forward's layer j
        # routes (1, b * p, k), token (row, position) at row * p + position
        per_step = [steps[i * layers:(i + 1) * layers] for i in range(p)]
        return [torch.stack([per_step[i][j][0] for i in range(p)], 1)
                .reshape(1, b * p, -1) for j in range(layers)]

    full = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k + 1e-6)
    if moe._capacity(b * p, full) < b * p:
        fail("the raised capacity does not hold every token")
    ctx = serve.install_gemm_context(planner, dev)
    mmad_mod.reset_launch_count()
    with torch.inference_mode(), choices.pinned(by_layer):
        naive = forward(params, prompts, full, remat=False)[:, -1]
    launches = mmad_mod.launch_count()
    shard_ctx.set_gemm_context(None)
    if launches != ctx.stats.executed_gemm:
        fail(f"the naive forward launched mmad {launches} times for "
             f"{ctx.stats.executed_gemm} routed GEMM dispatches")
    table = launch_table(torch, cfg, planner, ctx)
    if sum(r["count"] for r in table.values()) != launches:
        fail(f"the naive forward's launch table {table} does not add up to "
             f"its {launches} launches")
    worst = hold_shapes(torch, mmad_mod, ref, cfg, table, dev, SEED + 3)
    print(f"the naive forward's {len(table)} GEMM shapes "
          f"{sorted(k[:3] for k in table)} held to the plain version at the "
          f"plan's blocks: worst err/tol {worst:.3f}", flush=True)
    rel = float((naive - absorbed).norm() / absorbed.norm())
    print(f"MLA naive form (one batched forward of the {p}-token prompt, "
          f"{launches} mmad launches, attention "
          f"{sorted(ctx.stats.modes.items())}) against the absorbed decode "
          f"at position {p - 1}, expert choices pinned: logits rel L2 "
          f"{rel:.3e} (tolerance {NAIVE_ABSORBED_REL_L2}), max abs "
          f"{float((naive - absorbed).abs().max()):.3e}, greedy tokens equal "
          f"in {int((naive.argmax(-1) == absorbed.argmax(-1)).sum())}/{b} "
          f"rows; {choices.same_input_flips()} of {choices.token_layers} "
          f"decode token-layers chose otherwise under x @ w on the same "
          f"input", flush=True)
    if not (math.isfinite(rel) and rel <= NAIVE_ABSORBED_REL_L2):
        fail(f"MLA's naive and absorbed forms differ: rel L2 {rel}")
    return {"naive_absorbed_rel_l2": rel, "naive_launches": launches,
            "naive_shapes": len(table), "naive_err_over_tolerance": worst}


def both_forms(torch, mmad_mod, cfg, dev, params, planner, tokens):
    """The routed decode fed `tokens` one at a time, then one routed batched
    `forward` of them (`routed_forward`: each `mmad` call held on its
    operands): (chunked logits, recurrent logits, the forward's launches,
    its per-shape table and operand check, seconds of each)."""
    from repro_torch.launch import serve
    from repro_torch.models.model import decode_init, decode_step

    b, s = tokens.shape
    serve.install_gemm_context(planner, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        caches = decode_init(params, cfg, b, s)
        steps = []
        for i in range(s):
            logits, caches = decode_step(params, caches, tokens[:, i:i + 1],
                                         i, cfg)
            steps.append(logits)
        recurrent = torch.stack(steps, 1)
    serve._sync(dev)
    recurrent_s = time.perf_counter() - t0
    del caches, steps
    if not bool(torch.isfinite(recurrent).all()):
        fail(f"non-finite logits in the {cfg.dtype} recurrent decode")
    chunked, launches, table, operands, chunked_s = routed_forward(
        torch, mmad_mod, cfg, dev, params, planner, tokens)
    return chunked, recurrent, launches, table, operands, chunked_s, \
        recurrent_s


def chunked_vs_recurrent(torch, mmad_mod, cfg, dev, params, planner):
    """A recurrent stack's two forms on the same weights: the routed decode
    fed CHECK_BATCH x CHECK_SEQ tokens one at a time (the recurrent Mamba2
    / mLSTM / sLSTM steps on their states, the shared attention through
    its KV caches), against one routed batched `forward` of the same
    tokens (the chunked SSD and mLSTM forms over two chunks). In bf16 the
    forward's GEMMs run at M = CHECK_BATCH x CHECK_SEQ on the tensor-core
    kernel and the fp32 gates on the SIMT tile kernel: each call is held
    to the plain version on its own operands, and each shape at the plan's
    block; the logits' rel L2 and greedy-token agreement are printed. On
    the weights in fp32 the logits at every position are held to
    CHUNKED_RECURRENT_REL_L2 (see `CHECK_BATCH`'s note)."""
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    tokens = torch.randint(0, cfg.vocab, (CHECK_BATCH, CHECK_SEQ),
                           generator=gen).to(dev)
    chunked, recurrent, launches, table, operands, chunked_s, recurrent_s = \
        both_forms(torch, mmad_mod, cfg, dev, params, planner, tokens)
    worst = hold_shapes(torch, mmad_mod, ref, cfg, table, dev, SEED + 3)
    print(f"the chunked forward's {len(table)} GEMM shapes "
          f"{sorted(k[:3] for k in table)} held to the plain version at the "
          f"plan's blocks: worst err/tol {worst:.3f}; its {operands.calls} "
          f"calls on their own operands: worst err/tol "
          f"{operands.worst:.3f}", flush=True)
    rel = float((chunked - recurrent).norm() / recurrent.norm())
    agree = float((chunked.argmax(-1) == recurrent.argmax(-1)).float().mean())
    del chunked, recurrent
    cfg32, params32 = fp32_copy(torch, cfg, params)
    chunked, recurrent, *_ = both_forms(torch, mmad_mod, cfg32, dev,
                                        params32, planner, tokens)
    del params32
    serve._sync(dev)
    rel32 = float((chunked - recurrent).norm() / recurrent.norm())
    agree32 = float((chunked.argmax(-1) == recurrent.argmax(-1))
                    .float().mean())
    print(f"{cfg.name} chunked forward ({CHECK_BATCH} x {CHECK_SEQ} tokens, "
          f"{launches} mmad launches, {chunked_s:.2f}s) against the "
          f"recurrent decode of the same tokens ({recurrent_s:.2f}s), logits "
          f"over all positions: in bf16 rel L2 {rel:.3e} (not held), greedy "
          f"tokens equal at {agree:.1%} of positions; on the weights in fp32 "
          f"rel L2 {rel32:.3e} (tolerance {CHUNKED_RECURRENT_REL_L2}), max "
          f"abs {float((chunked - recurrent).abs().max()):.3e}, greedy "
          f"tokens equal at {agree32:.1%}", flush=True)
    if not (math.isfinite(rel32) and rel32 <= CHUNKED_RECURRENT_REL_L2):
        fail(f"{cfg.name}'s chunked and recurrent forms differ: rel L2 "
             f"{rel32} in fp32")
    return {"chunked_recurrent_rel_l2": rel32,
            "chunked_recurrent_rel_l2_bf16": rel,
            "chunked_token_agreement": agree32,
            "chunked_token_agreement_bf16": agree,
            "chunked_launches": launches, "chunked_shapes": len(table),
            "chunked_err_over_tolerance": worst,
            "chunked_operands_err_over_tolerance": operands.worst}


def routed_forward(torch, mmad_mod, cfg, dev, params, planner, tokens,
                   **inputs):
    """One routed batched `forward` of `tokens` with the frontend `inputs`
    on a fresh routing context, the launch count from zero, each `mmad`
    call held to the plain version on its own operands (`OperandCheck`):
    fails unless every routed GEMM dispatch launched once, resolved, and
    agreed, and, on the card, unless every bf16 call past the stream
    kernels' rows took the tensor-core kernel. Returns the logits, the
    launches, the per-shape table (`calls_table`), the check and the
    seconds it took."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import forward

    ctx = serve.install_gemm_context(planner, dev)
    operands = OperandCheck(torch, mmad_mod)
    mmad_mod.reset_launch_count()
    t0 = time.perf_counter()
    try:
        with torch.inference_mode(), operands.watching():
            logits = forward(params, tokens, cfg, remat=False, **inputs)
        serve._sync(dev)
    finally:
        shard_ctx.set_gemm_context(None)
    seconds = time.perf_counter() - t0
    launches = mmad_mod.launch_count()
    stats = ctx.stats
    if launches != stats.executed_gemm or operands.calls != launches:
        fail(f"the {cfg.name} forward launched mmad {launches} times for "
             f"{stats.executed_gemm} routed GEMM dispatches "
             f"({operands.calls} calls watched)")
    if stats.resolve_rate != 1.0 or stats.silent_degrades:
        fail(f"the {cfg.name} forward resolved {stats.resolve_rate} of its "
             f"GEMMs, {stats.silent_degrades} silent degrades")
    if not operands.worst <= 1.0:
        fail(f"the {cfg.name} forward's mmad calls differ from the plain "
             f"version on their operands: {operands.worst:.2f}x the "
             f"tolerance")
    off = [key for key, rec in operands.shapes.items()
           if dev.type == "cuda" and key[0] > mmad_mod.STREAM_MAX_M
           and rec["dtype"] in mmad_mod.WGMMA_DTYPES
           and rec["tensor_core"] != rec["calls"]]
    if off:
        fail(f"the {cfg.name} forward's shapes {off} left the tensor-core "
             f"kernel")
    if not bool(torch.isfinite(logits).all()):
        fail(f"non-finite logits in the {cfg.name} forward")
    return (logits, launches, calls_table(planner, ctx, operands.shapes),
            operands, seconds)


def encoder_vs_decode(torch, mmad_mod, cfg, dev, params, planner, prompts):
    """An encoder-decoder's two paths on the same weights: one routed
    batched `forward` of BATCH x n_prefix random frames (FRONTEND_SCALE)
    and the prompt (the encoder non-causal over the frames, its GEMMs at
    BATCH x n_prefix rows on the tensor-core kernel, as are the decoder's
    cross-attention K and V; the decoder over the prompt, lm_head at
    BATCH x PROMPT rows over the ragged vocabulary), each `mmad` call held
    on its operands and each shape at the plan's block; against the routed
    decode of the prompt token by token, attending to the encoder output
    of the same frames (`model._encode`, under the same routing). The logits at every prompt
    position are held to ENCODER_DECODE_REL_L2 in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import model, shard_ctx

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    frames = (torch.randn((BATCH, cfg.n_prefix, cfg.d_model), generator=g,
                          device=dev) * FRONTEND_SCALE).to(cfg.dtype)
    fwd, launches, table, operands, fwd_s = routed_forward(
        torch, mmad_mod, cfg, dev, params, planner, prompts,
        encoder_embeds=frames)
    worst = hold_shapes(torch, mmad_mod, ref, cfg, table, dev, SEED + 3)
    tensor_core = sum(rec["tensor_core"] for rec in operands.shapes.values())
    print(f"{cfg.name} forward's {len(table)} GEMM shapes "
          f"{sorted(k[:3] for k in table)} held to the plain version at the "
          f"plan's blocks: worst err/tol {worst:.3f}; its {operands.calls} "
          f"calls ({tensor_core} on the tensor-core kernel) on their own "
          f"operands: worst err/tol {operands.worst:.3f}", flush=True)
    serve.install_gemm_context(planner, dev)
    try:
        with torch.inference_mode():
            encoder_out = model._encode(params, frames, cfg)
            serve._sync(dev)
            t0 = time.perf_counter()
            caches = model.decode_init(params, cfg, BATCH, PROMPT)
            steps = []
            for i in range(PROMPT):
                logits, caches = model.decode_step(
                    params, caches, prompts[:, i:i + 1], i, cfg,
                    encoder_out=encoder_out)
                steps.append(logits)
            decode = torch.stack(steps, 1)
            serve._sync(dev)
            decode_s = time.perf_counter() - t0
    finally:
        shard_ctx.set_gemm_context(None)
    del caches, steps, encoder_out
    rel = float((fwd - decode).norm() / decode.norm())
    agree = float((fwd.argmax(-1) == decode.argmax(-1)).float().mean())
    print(f"{cfg.name} routed forward ({BATCH} x {cfg.n_prefix} frames + "
          f"{BATCH} x {PROMPT} tokens, {launches} mmad launches, "
          f"{fwd_s:.2f}s) against the routed decode of the prompt on its "
          f"encoder output ({decode_s:.2f}s), logits at every prompt "
          f"position in bf16: rel L2 {rel:.3e} (tolerance "
          f"{ENCODER_DECODE_REL_L2}), max abs "
          f"{float((fwd - decode).abs().max()):.3e}, greedy tokens equal at "
          f"{agree:.1%}", flush=True)
    if not (math.isfinite(rel) and rel <= ENCODER_DECODE_REL_L2):
        fail(f"{cfg.name}'s forward and decode differ: rel L2 {rel}")
    return {"encoder_decode_rel_l2": rel, "encoder_token_agreement": agree,
            "encoder_launches": launches,
            "encoder_tensor_core_launches": tensor_core,
            "encoder_shapes": len(table), "encoder_err_over_tolerance": worst,
            "encoder_operands_err_over_tolerance": operands.worst,
            "forward_table": table}


def prefix_forward(torch, mmad_mod, cfg, dev, params, planner, prompts):
    """A VLM's forward with its stub frontend's input: BATCH x n_prefix
    random patch embeddings (FRONTEND_SCALE) through `frontend.proj` and
    prepended to the prompt, one routed batched `forward` (its GEMMs at
    BATCH x (n_prefix + PROMPT) rows on the tensor-core kernel, lm_head on
    `embed.T` with a ragged last tile), each `mmad` call held on its
    operands and each shape at the plan's block, against the unrouted
    forward (`x @ w`) on the same weights: the logits at every position
    held to PREFIX_FORWARD_REL_L2 in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import forward

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    patches = (torch.randn((BATCH, cfg.n_prefix, cfg.d_model), generator=g,
                           device=dev) * FRONTEND_SCALE).to(cfg.dtype)
    routed, launches, table, operands, fwd_s = routed_forward(
        torch, mmad_mod, cfg, dev, params, planner, prompts,
        prefix_embeds=patches)
    if tuple(routed.shape) != (BATCH, cfg.n_prefix + PROMPT, cfg.vocab):
        fail(f"prefix forward logits of shape {tuple(routed.shape)}")
    worst = hold_shapes(torch, mmad_mod, ref, cfg, table, dev, SEED + 3)
    tensor_core = sum(rec["tensor_core"] for rec in operands.shapes.values())
    shard_ctx.set_gemm_context(None)
    with torch.inference_mode():
        plain = forward(params, prompts, cfg, remat=False,
                        prefix_embeds=patches)
    rel = float((routed - plain).norm() / plain.norm())
    agree = float((routed.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"{cfg.name} routed forward of {BATCH} x {cfg.n_prefix} patch "
          f"embeddings + {BATCH} x {PROMPT} tokens ({launches} mmad "
          f"launches, {tensor_core} on the tensor-core kernel, {fwd_s:.2f}s; "
          f"{len(table)} GEMM shapes {sorted(k[:3] for k in table)} held to "
          f"the plain version at the plan's blocks, worst err/tol "
          f"{worst:.3f}; each call on its own operands, worst err/tol "
          f"{operands.worst:.3f}) against the unrouted forward, logits at "
          f"every position in bf16: rel L2 {rel:.3e} (tolerance "
          f"{PREFIX_FORWARD_REL_L2}), max abs "
          f"{float((routed - plain).abs().max()):.3e}, greedy tokens equal "
          f"at {agree:.1%}", flush=True)
    if not (math.isfinite(rel) and rel <= PREFIX_FORWARD_REL_L2):
        fail(f"{cfg.name}'s routed prefix forward differs from the "
             f"unrouted one: rel L2 {rel}")
    return {"prefix_rel_l2": rel, "prefix_token_agreement": agree,
            "prefix_launches": launches,
            "prefix_tensor_core_launches": tensor_core,
            "prefix_shapes": len(table), "prefix_err_over_tolerance": worst,
            "prefix_operands_err_over_tolerance": operands.worst,
            "forward_table": table}


# `serve --traffic` at full width (TRAFFIC_ARCH), in both batch modes,
# through `serve.main` with the launcher's own traffic defaults: 2 tenants
# x 12 requests at 100 req/s, seed 0, prompts of 5-17 tokens, 2-5 generated.
# Its virtual clock is the cost model's (`launch/traffic.py`), not the
# card's: each distinct GEMM shape the replay admits runs once on the card.
TRAFFIC_ARCH = "gemma-2b"
TRAFFIC_MODES = ("bucket", "fifo")
H100_SMS = 132          # H100 SXM: the SM count `plan_launch` is given


def route_name(mmad_mod, variant: int) -> str:
    return {mmad_mod.ROW_STREAM: "row stream",
            mmad_mod.COL_STREAM: "column stream",
            mmad_mod.WGMMA: "tensor-core",
            mmad_mod.TILE: "SIMT tile"}[variant]


def traffic_routes(torch, mmad_mod, table, dev, mode: str) -> dict:
    """The variant `mmad` takes for each shape of a traffic replay's launch
    table, with the operands its dispatch lays out (contiguous (m, k) and
    (k, n) of the table's dtype on `dev`, left uninitialised) and the
    card's SM count (an H100's on the CPU), as `plan_launch` decides. Fails
    unless M <= STREAM_MAX_M takes a stream kernel and every larger M of a
    tensor-core dtype the tensor-core kernel, and unless FIFO's replay sent
    a ragged M above STREAM_MAX_M (not a power of two: a partial 128-row
    tile, the kernel's masked edges) to the tensor-core kernel."""
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    routes = {}
    for key, info in sorted(table.items()):
        m, n, k = key[:3]
        a = torch.empty((m, k), dtype=info["dtype"], device=dev)
        w = torch.empty((k, n), dtype=info["dtype"], device=dev)
        routes[key] = mmad_mod.plan_launch(
            m, n, k, info["block"], sms, mmad_mod.b_layout(w),
            info["dtype"].itemsize, mmad_mod.wgmma_b_major(a, w))[0]
        del a, w
    streams = (mmad_mod.ROW_STREAM, mmad_mod.COL_STREAM)
    off = [key for key, variant in routes.items()
           if (variant in streams) != (key[0] <= mmad_mod.STREAM_MAX_M)
           or (key[0] > mmad_mod.STREAM_MAX_M
               and table[key]["dtype"] in mmad_mod.WGMMA_DTYPES
               and variant != mmad_mod.WGMMA)]
    if off:
        fail(f"traffic [{mode}] shapes off their route: "
             f"{[(key[:3], route_name(mmad_mod, routes[key])) for key in off]}")
    ragged = [key for key, variant in routes.items()
              if key[0] > mmad_mod.STREAM_MAX_M and key[0] & (key[0] - 1)
              and variant == mmad_mod.WGMMA]
    if mode == "fifo" and not ragged:
        fail("the FIFO replay sent no ragged M above "
             f"{mmad_mod.STREAM_MAX_M} to the tensor-core kernel")
    by_m = {}
    for key, variant in routes.items():
        by_m.setdefault(key[0], set()).add(route_name(mmad_mod, variant))
    print(f"traffic [{mode}] routes by M: " + "; ".join(
        f"{m}: {'/'.join(sorted(names))}" for m, names in sorted(by_m.items())),
        flush=True)
    return routes


def serve_traffic(torch, mmad_mod, dev, mode: str, smoke: bool = False,
                  fresh: bool = True) -> dict:
    """One `serve --traffic` run of TRAFFIC_ARCH in batch `mode` through
    `serve.main` (its plan cache wiped first when `fresh`, else the earlier
    mode's). Asserts its run report's `serving` section equal to that of
    `simulate` without dispatch on the same trace and planner (the card's
    dispatches change no admission or plan decision), plan-resolve rate
    1.0, no silent degrade, `mmad` launches == distinct shapes dispatched ==
    routed dispatches, one `serve.request` marker per request, and each
    dispatched shape's route (`traffic_routes`). The timing phase holds
    every dispatched shape to the plain version on random operands (the
    replay's zeros prove nothing) through the wrapper the path calls.
    Returns the launches, the section, the launch table and the seconds
    `serve.main` took."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve, traffic
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer

    cfg = (smoke_config if smoke else get_config)(TRAFFIC_ARCH)
    out = ROOT / "build" / "chip_smoke"
    plans = out / "traffic_plans"
    if fresh:
        shutil.rmtree(plans, ignore_errors=True)
    report_path, trace_path = (out / f"traffic_{mode}_report.json",
                               out / f"traffic_{mode}_trace.json")
    argv = (["--arch", TRAFFIC_ARCH, "--device", dev.type, "--traffic",
             "--batch-mode", mode, "--plan-cache", str(plans),
             "--run-report", str(report_path), "--trace", str(trace_path)]
            + (["--smoke"] if smoke else []))
    seen = {}
    real_simulate = traffic.simulate

    def recorded(trace, planner, cfgs, **kw):
        seen.update(trace=trace, planner=planner, cfgs=cfgs, kw=kw)
        return real_simulate(trace, planner, cfgs, **kw)

    traffic.simulate = recorded
    mmad_mod.reset_launch_count()
    t0 = time.perf_counter()
    try:
        report = serve.main(argv)
        seconds = time.perf_counter() - t0
        launches = mmad_mod.launch_count()
        ctx = shard_ctx.get_gemm_context()
    finally:
        traffic.simulate = real_simulate
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
    section = report["serving"]
    if json.loads(report_path.read_text()) != json.loads(json.dumps(report)):
        fail(f"traffic [{mode}]: the written run report is not the one "
             f"serve returned")
    plain = traffic.serving_section(real_simulate(
        seen["trace"], seen["planner"], seen["cfgs"],
        **dict(seen["kw"], dispatch=None)))
    if json.loads(json.dumps(plain)) != json.loads(json.dumps(section)):
        fail(f"traffic [{mode}]: the run report's serving section differs "
             f"from simulate's without dispatch on the same trace and "
             f"planner: {section} against {plain}")
    stats = ctx.stats
    if stats.resolve_rate != 1.0 or section["resolve_rate"] != 1.0:
        fail(f"traffic [{mode}] plan-resolve rate {stats.resolve_rate} "
             f"(replay {section['resolve_rate']})")
    if stats.silent_degrades:
        fail(f"traffic [{mode}]: {stats.silent_degrades} silent degrades")
    distinct = section["distinct_shapes"]
    if not launches == distinct == stats.executed_gemm > 0:
        fail(f"traffic [{mode}]: mmad launched {launches} times for "
             f"{distinct} distinct shapes and {stats.executed_gemm} routed "
             f"dispatches")
    events = json.loads(trace_path.read_text())["traceEvents"]
    markers = sum(e.get("name") == "serve.request" for e in events)
    if markers != section["requests"]:
        fail(f"traffic [{mode}]: {markers} serve.request markers for "
             f"{section['requests']} requests")
    table = {}
    for tag, shape in ctx.resolved:
        if not tag.startswith("traffic."):
            fail(f"traffic [{mode}] dispatched {tag}")
        key = (shape.m, shape.n, shape.k, str(cfg.dtype))
        table[key] = {"block": plan_block(seen["planner"], ctx, shape,
                                          cfg.dtype.itemsize),
                      "count": 1, "dtype": cfg.dtype}
    if len(table) != distinct:
        fail(f"traffic [{mode}]: {len(table)} shapes in the launch table for "
             f"{distinct} distinct shapes")
    traffic_routes(torch, mmad_mod, table, dev, mode)
    print(f"serve {cfg.name} --traffic [{mode}] on the virtual clock (the "
          f"cost model's, not the card's time): {section['requests']} "
          f"requests, goodput {section['goodput_tps']:.1f} tok/s, p99 "
          f"latency {section['p99_latency_s'] * 1e3:.3f} ms, "
          f"{section['batches']} batches, {distinct} distinct shapes "
          f"({section['cold_shapes']} cold); on {dev}: {launches} mmad "
          f"launches, resolve rate {stats.resolve_rate}; serve.main took "
          f"{seconds:.2f} s (the pool's plans warmed, each shape run once)",
          flush=True)
    return {"launches": launches, "serving": section, "table": table,
            "seconds": seconds}


def train_steps(torch, s, batch, dev, n: int, state=None, step_fn=None):
    """`n` steps of the trainer's step function (or `step_fn`) on one fixed
    batch from a fresh state (the launcher's seeded weights, zero moments;
    or `state`). Returns the state, and per step the loss and grad norm it
    reports (both taken before its update) and its wall ms."""
    from repro_torch.launch import serve

    state = s.init_state() if state is None else state
    step_fn = step_fn or s.step_fn
    losses, norms, step_ms = [], [], []
    for _ in range(n):
        serve._sync(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        serve._sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, step_ms


def check_trajectory(losses, norms, ref_losses, ref_norms) -> None:
    """The routed run's losses (before each step, then after the last) and
    grad norms against the unrouted run's: finite, within STEP0_REL at
    step 0 and LATER_*_REL after it, every step moving the loss the same
    way as in the unrouted run, and the loss ending below its start."""
    def rel(got, want):
        return [abs(x - y) / abs(y) for x, y in zip(got, want)]

    rel_loss, rel_norm = rel(losses, ref_losses), rel(norms, ref_norms)
    print(f"train trajectory on the fixed batch, routed vs unrouted: losses "
          f"{losses} vs {ref_losses} (rel {[f'{x:.2e}' for x in rel_loss]}; "
          f"tolerance {STEP0_REL} at step 0, {LATER_LOSS_REL} after); grad "
          f"norms {norms} vs {ref_norms} (rel "
          f"{[f'{x:.2e}' for x in rel_norm]}; tolerance {STEP0_REL} at step "
          f"0, {LATER_GNORM_REL} after)", flush=True)
    if not all(math.isfinite(x) for x in losses + norms):
        fail("non-finite loss or grad norm")
    if not (rel_loss[0] <= STEP0_REL and rel_norm[0] <= STEP0_REL):
        fail("routed step 0 differs from unrouted")
    if not (max(rel_loss[1:]) <= LATER_LOSS_REL
            and max(rel_norm[1:]) <= LATER_GNORM_REL):
        fail("the routed trajectory left the unrouted one")
    for i in range(len(losses) - 1):
        if ((losses[i + 1] > losses[i])
                != (ref_losses[i + 1] > ref_losses[i])):
            fail(f"step {i} moved the routed loss the other way than the "
                 f"unrouted one")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")


def check_fp32_trajectory(losses, norms, ref_losses, ref_norms) -> None:
    """A chaotic stack's trajectory on fp32 copies (FP32_HELD_TRAIN), the
    routed run's against the unrouted one's: finite, the step-0 loss within
    STEP0_REL, each run's loss ending below its start. The grad norms and
    the later losses are printed: the step-0 gradients are held leaf by
    leaf on their own operands (`block_operand_check`)."""
    def rel(got, want):
        return [abs(x - y) / abs(y) for x, y in zip(got, want)]

    rel_loss, rel_norm = rel(losses, ref_losses), rel(norms, ref_norms)
    print(f"train trajectory on the fixed batch on the weights in fp32, "
          f"routed vs unrouted: losses {losses} vs {ref_losses} (rel "
          f"{[f'{x:.2e}' for x in rel_loss]}; tolerance {STEP0_REL} at step "
          f"0, later steps not held); grad norms {norms} vs {ref_norms} (rel "
          f"{[f'{x:.2e}' for x in rel_norm]}; not held: see "
          f"FP32_HELD_TRAIN)", flush=True)
    if not all(math.isfinite(x) for x in losses + norms + ref_losses
               + ref_norms):
        fail("non-finite loss or grad norm in fp32")
    if not rel_loss[0] <= STEP0_REL:
        fail("routed step 0 differs from unrouted in fp32")
    if not (losses[-1] < losses[0] and ref_losses[-1] < ref_losses[0]):
        fail(f"an fp32 run's loss did not fall: {losses}, {ref_losses}")


TENSOR_CORE_KERNEL = "mmad_wgmma_kernel"
SIMT_TILE_KERNEL = "mmad_tile_kernel"
SPLITK_REDUCE_KERNEL = "mmad_splitk_reduce"
# substrings of the names of cuBLAS's and CUTLASS's GEMM kernels, and of
# those among them that read fp32 operands: on an H100 (torch 2.11, CUDA
# 12.8) an fp32 matmul or einsum runs cutlass_80_simt_sgemm_*, a bf16 one
# nvjet_tst_* (bf16 out) or nvjet_tss_* (fp32 out): nvjet's three letters
# are the input, compute and output types, so nvjet_s* reads fp32
LIBRARY_GEMM = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
FP32_GEMM = ("sgemm", "simt", "f32f32_f32f32", "nvjet_s")


def library_gemms(kernels):
    """The library GEMM kernels among `device_kernels`' rows, and those of
    them that read fp32 operands on the CUDA cores."""
    library = [(us, count, name) for us, count, name in kernels
               if "mmad" not in name
               and any(w in name.lower() for w in LIBRARY_GEMM)]
    fp32 = [(us, count, name) for us, count, name in library
            if any(w in name.lower() for w in FP32_GEMM)]
    return library, fp32


def train_profile(torch, mmad_mod, s, state, batch, dev,
                  launches_per_step: int, simt_per_step: int = 0,
                  fp32_backward_per_step: int = 0, scan_fp32=None):
    """One more step under a device-only profile: busy and wall time from
    one window; every mmad kernel must be the tensor-core kernel, as many
    as the step's launches (one per routed dispatch and two per backward
    call; it fixes a K split up in the same launch, so no reduce kernel
    runs), except the `simt_per_step` fp32 launches of an MoE router, which
    run the SIMT tile kernel (each followed by at most one split-K reduce
    kernel). The library GEMM kernels that take fp32 operands on the CUDA
    cores must be exactly those the reference computes in fp32: the
    router's backward, two `torch.matmul` products per fp32 backward call,
    and the MoE combine weights' einsum, once per route call (one per
    router launch: forward and remat recompute) and once in each MoE
    layer's backward (one per fp32 backward call). A dense step has none.
    A recurrent stack (`scan_fp32` given) has its fp32 gates' two backward
    products per fp32 backward call and the `scan_fp32` of its scans'
    einsums, which sum in fp32 by design (`scan_library_gemms`). A model
    product that ran as an fp32 library GEMM instead of `mmad` would add
    one."""
    with device_profile(torch, dev) as prof:
        t0 = time.perf_counter()
        state, _ = s.step_fn(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    edges = edge_kernels_kept(torch, prof)
    kernels = device_kernels(torch, prof)
    mmad = [(us, count, name) for us, count, name in kernels
            if "mmad" in name]

    def calls(kernel):
        return sum(count for _, count, name in mmad if kernel in name)

    tiles, simt = calls(TENSOR_CORE_KERNEL), calls(SIMT_TILE_KERNEL)
    reduces = calls(SPLITK_REDUCE_KERNEL)
    other = [name for _, _, name in mmad
             if not any(k in name for k in (TENSOR_CORE_KERNEL,
                                            SIMT_TILE_KERNEL,
                                            SPLITK_REDUCE_KERNEL))]
    if other:
        fail(f"the train step launched other mmad kernels: {other}")
    if (tiles != launches_per_step - simt_per_step or simt != simt_per_step
            or reduces > simt):
        fail(f"{tiles} tensor-core, {simt} SIMT tile and {reduces} reduce "
             f"kernels ran in a step of {launches_per_step} mmad launches, "
             f"{simt_per_step} of them fp32")
    library, fp32 = library_gemms(kernels)
    if scan_fp32 is None:
        want_fp32 = simt_per_step + 3 * fp32_backward_per_step
        of = f"{simt_per_step} route calls"
    else:
        want_fp32 = 2 * fp32_backward_per_step + scan_fp32
        of = f"the scans' {scan_fp32}"
    if sum(count for _, count, _ in fp32) != want_fp32:
        fail(f"the train step ran {sum(count for _, count, _ in fp32)} fp32 "
             f"CUDA-core GEMM kernels, not the {want_fp32} of its "
             f"{fp32_backward_per_step} fp32 backward calls and {of}: "
             f"{[(count, name[:100]) for _, count, name in fp32]}")
    for us, count, name in library:
        print(f"  library GEMM {us / 1e3:9.3f} ms/step  {count:6d} "
              f"calls/step  {name[:100]}", flush=True)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    mmad_ms = sum(us for us, _, _ in mmad) / 1e3
    simt_ms = sum(us for us, _, name in mmad
                  if TENSOR_CORE_KERNEL not in name) / 1e3
    fp32_ms = sum(us for us, _, _ in fp32) / 1e3
    for us, count, name in kernels[:10]:
        print(f"  device {us / 1e3:9.3f} ms/step  {count:6d} calls/step  "
              f"{name[:80]}", flush=True)
    print(f"profiled train step: device busy {busy_ms:.3f} ms ({mmad_ms:.3f} "
          f"ms in mmad: {tiles} tensor-core kernels, {simt} SIMT tile "
          f"kernels + {reduces} reduces taking {simt_ms:.3f} ms; "
          f"{want_fp32} fp32 library GEMMs {fp32_ms:.3f} ms) "
          f"against {wall_ms:.3f} ms wall in the same window: busy share "
          f"{busy_ms / wall_ms:.1%}; the profile kept {edges[0]} + "
          f"{edges[1]} of its 2 x {PROFILE_EDGE_KERNELS} edge kernels",
          flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "mmad_ms": mmad_ms,
            "simt_ms": simt_ms, "fp32_library_ms": fp32_ms}


def resume_check(torch, dev):
    """The crash-resume loop on the card at smoke width: a failure injected
    at step 3, a checkpoint every 2 steps; the final state must equal an
    uninterrupted run's, bitwise."""
    from repro_torch.ckpt.manager import flatten
    from repro_torch.ft.runtime import FailureInjector
    from repro_torch.launch import train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer

    work = ROOT / "build" / "chip_smoke" / "resume"
    shutil.rmtree(work, ignore_errors=True)
    finals, injector = {}, FailureInjector(fail_at={3})
    for name, inj in (("clean", None), ("faulty", injector)):
        s = train.setup(train.parse_args([
            "--arch", "gemma-2b", "--smoke", "--device", dev.type,
            "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every",
            "2", "--ckpt-dir", str(work / name), "--plan-cache",
            str(work / "plans")]))
        finals[name] = flatten(train.run(s, injector=inj))
        if s.gemm_ctx.stats.resolve_rate != 1.0:
            fail(f"smoke training resolve rate {s.gemm_ctx.stats.resolve_rate}")
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
    if injector.failed != {3}:
        fail(f"the injected failure did not fire ({injector.failed})")
    diff = [name for (name, a), (_, b) in zip(finals["faulty"],
                                              finals["clean"])
            if not torch.equal(a, b)]
    if diff or len(finals["faulty"]) != len(finals["clean"]):
        fail(f"resumed run ended on other values than the uninterrupted "
             f"one: {diff[:5]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"resume at smoke width on {dev}: failure injected at step 3, "
          f"restored from the step-1 checkpoint; all "
          f"{len(finals['clean'])} state tensors equal an uninterrupted "
          f"6-step run's, bitwise", flush=True)


class ChoiceLog:
    """Expert choices across runs: `recording` wraps `models.moe.route` to
    keep each call's top-k choice with its input and a copy of the router
    weights it saw (an optimizer step updates them in place), and adds no
    other device work and no host sync to the run it records;
    `same_input_flips` then counts the calls where the unrouted router
    (`x @ w`, no context) chooses otherwise on the same input. `pinned`
    wraps `route` to hand the recorded choices back, call by call, to a run
    that takes its gates from its own router. Training runs the same route
    calls in the same order whether routed or not (forward, then each layer
    again in the backward's recomputation), so the queue lines up."""

    def __init__(self, torch):
        self.torch = torch
        self.choices = []
        self.inputs = []

    @property
    def token_layers(self) -> int:
        return sum(int(t.shape[0] * t.shape[1]) for t in self.choices)

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import moe
        real = moe.route

        def route(p, xt, c):
            topv, topi = real(p, xt, c)
            self.choices.append(topi.detach())
            self.inputs.append((xt.detach(), p.router.detach().clone(), c))
            return topv, topi

        moe.route = route
        try:
            yield self
        finally:
            moe.route = real

    def same_input_flips(self) -> int:
        """Recorded calls' token-layers whose top-k set `x @ w` on the
        recorded input and router weights does not choose."""
        from types import SimpleNamespace
        from repro_torch.models import moe, shard_ctx
        ctx = shard_ctx.get_gemm_context()
        shard_ctx.set_gemm_context(None)
        try:
            with self.torch.inference_mode():
                return sum(choice_flips(topi, moe.route(
                    SimpleNamespace(router=w), xt, c)[1])
                    for topi, (xt, w, c) in zip(self.choices, self.inputs))
        finally:
            shard_ctx.set_gemm_context(ctx)

    @contextlib.contextmanager
    def pinned(self, arrange=None):
        """Hand back the recorded choices in order (`arrange` maps the
        queue, call by call, to what each route call takes); fails if a
        call finds the queue empty or leaves any behind."""
        from repro_torch.models import moe
        from repro_torch.models.matmul import pmm
        torch = self.torch
        real = moe.route
        queue = list(arrange(self.choices) if arrange else self.choices)

        def route(p, xt, c):
            gates = torch.softmax(pmm(xt.float(), p.router, tag="moe.router"),
                                  dim=-1)
            if not queue:
                fail("a pinned run routed more MoE layers than were recorded")
            topi = queue.pop(0)
            if topi.shape[:2] != xt.shape[:2]:
                fail(f"pinned choices {tuple(topi.shape)} for tokens "
                     f"{tuple(xt.shape[:2])}")
            topv = gates.gather(-1, topi)
            return (topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9),
                    topi)

        moe.route = route
        try:
            yield self
        finally:
            moe.route = real
        if queue:
            fail(f"a pinned run left {len(queue)} recorded choices unused")


def choice_flips(a, b) -> int:
    """Token-layers whose top-k sets differ between two (G, TL, k) choices."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def launcher_batch(torch, s):
    """The launcher's first `SyntheticLM` batch on the device."""
    return s.batch_arrays(s.data.batch(0))


def frontend_batch(torch, s):
    """The launcher's first batch plus the frontend's input, built here (the
    launcher feeds none, as the reference's does not): an encoder-decoder's
    `encoder_embeds` of TRAIN_BATCH x n_prefix random frames, a VLM's
    `prefix_embeds` of as many random patches, x FRONTEND_SCALE, from a
    seed."""
    cfg = s.cfg
    batch = launcher_batch(torch, s)
    key = "encoder_embeds" if cfg.is_encoder_decoder else "prefix_embeds"
    gen = torch.Generator(device=s.device).manual_seed(SEED + 11)
    batch[key] = (torch.randn((TRAIN_BATCH, cfg.n_prefix, cfg.d_model),
                              generator=gen, device=s.device)
                  * FRONTEND_SCALE).to(cfg.dtype)
    return batch


def fp32_trajectory(torch, s, batch, dev):
    """The held trajectory of a stack that amplifies bf16 rounding (see
    FP32_HELD_TRAIN): the seed-0 weights cast up to fp32, TRAIN_STEPS
    AdamW steps routed (every GEMM on `mmad`'s SIMT tile kernel forward,
    fp32 `torch.matmul` backward) and then unrouted (fp32 `x @ w`,
    PyTorch's backward) from the same fp32 weights; each run's losses
    (before each step, after the last) and grad norms, and the routed run's
    resolve rate and silent degrades."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params, make_trainable
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg32 = dataclasses.replace(s.cfg, dtype=torch.float32)
    step32 = steps.make_train_step(cfg32, s.opt)

    def step_fn(state, b):
        p, o, c, m = step32(*state, b)
        return (p, o, c), m

    runs = []
    for routed in (True, False):
        # the launcher's seed-0 weights (`TrainSetup.init_state`), cast up
        gen = torch.Generator(device=s.device).manual_seed(0)
        params = make_trainable(fp32_copy(
            torch, s.cfg, init_params(gen, s.cfg, s.device))[1])
        ctx = serve.install_gemm_context(s.planner, dev) if routed else None
        try:
            state, losses, norms, _ = train_steps(
                torch, s, batch, dev, TRAIN_STEPS,
                state=(params, adamw.init(params), None), step_fn=step_fn)
            with torch.no_grad():
                losses.append(float(steps.loss_fn(state[0], batch, cfg32)))
        finally:
            shard_ctx.set_gemm_context(None)
        runs.append((losses, norms, ctx))
        del state, params
        release(torch)
    (losses, norms, ctx), (ref_losses, ref_norms, _) = runs
    if ctx.stats.resolve_rate != 1.0 or ctx.stats.silent_degrades:
        fail(f"the fp32 routed run resolved {ctx.stats.resolve_rate} of its "
             f"GEMMs, {ctx.stats.silent_degrades} silent degrades")
    return losses, norms, ref_losses, ref_norms


def block_operand_check(torch, s, batch, dev) -> dict:
    """The step-0 gradients of a stack in FP32_HELD_TRAIN, on the seed-0
    weights cast up to fp32, held leaf by leaf on their own operands.
    One routed `loss_and_grads` records each recurrent block's input and
    output and the cotangents that reach them; then each block's
    backward is taken again unrouted (`x @ w`, PyTorch's backward) on that
    input and output cotangent, and so is the loss head's (the final norm
    and the tied `embed.T` projection, on the last block's output; `embed`
    adds its gather's gradient, the first block's input cotangent
    scattered to the tokens). Every leaf's routed gradient and every
    block's input cotangent must agree with its unrouted one within
    STEP0_REL (relative L2), and the head's loss with the routed loss: a
    block's backward then differs by its own products' summation order
    alone, where the whole stack's differs by what its depth makes of
    them (see FP32_HELD_TRAIN)."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod
    from repro_torch.models import shard_ctx
    from repro_torch.models.common import apply_norm
    from repro_torch.models.model import (init_params, lm_head_weight,
                                          make_trainable)
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    gen = torch.Generator(device=s.device).manual_seed(0)
    cfg32, params = fp32_copy(torch, s.cfg,
                              init_params(gen, s.cfg, s.device))
    make_trainable(params)
    names = {id(w): k for k, w in adamw.named(params).items()}
    real = model_mod._mixer_block
    blocks = {}

    def recording(p, x, cfg, state=None):
        y, new_state = real(p, x, cfg, state)
        # the first call of each block: the forward (its remat recompute
        # runs inside the backward, on the same input)
        if torch.is_grad_enabled() and id(p) not in blocks:
            rec = blocks[id(p)] = {"p": p, "x": x.detach(), "y": y.detach()}
            x.register_hook(lambda g: rec.__setitem__("dx", g.detach()))
            y.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return y, new_state

    model_mod._mixer_block = recording
    ctx = serve.install_gemm_context(s.planner, dev)
    try:
        loss, grads = steps.loss_and_grads(params, batch, cfg32)
    finally:
        model_mod._mixer_block = real
        shard_ctx.set_gemm_context(None)
    if ctx.stats.resolve_rate != 1.0 or ctx.stats.silent_degrades:
        fail(f"the fp32 routed step resolved {ctx.stats.resolve_rate} of its "
             f"GEMMs, {ctx.stats.silent_degrades} silent degrades")
    order = list(blocks.values())
    if len(order) != cfg32.n_layers or not all(
            "dx" in r and "dy" in r for r in order):
        fail(f"recorded {len(order)} blocks' operands and cotangents for "
             f"{cfg32.n_layers} layers")

    worst = {"rel": 0.0, "leaf": None}

    def hold(name, got, want):
        rel = float((got - want).norm() / want.norm())
        if not rel <= worst["rel"]:
            worst.update(rel=rel, leaf=name)

    held = set()
    for i, rec in enumerate(order):
        x = rec["x"].requires_grad_(True)
        ws = list(rec["p"].parameters())
        y = real(rec["p"], x, cfg32)[0]
        dx, *dws = torch.autograd.grad(y, [x, *ws], rec["dy"])
        hold(f"block {i} input", rec["dx"], dx)
        for w, dw in zip(ws, dws):
            hold(names[id(w)], grads[names[id(w)]], dw)
            held.add(names[id(w)])
        del y, dx, dws
    # the head, on the last block's output
    rest = [k for k in grads if k not in held]
    leaves = adamw.named(params)
    x_last = order[-1]["y"].requires_grad_(True)
    head_loss = steps.chunked_xent(
        apply_norm(params.ln_f, x_last, cfg32), lm_head_weight(params, cfg32),
        batch["targets"], cfg32.vocab)
    dx, *dws = torch.autograd.grad(head_loss, [x_last] + [leaves[k]
                                                          for k in rest],
                                   allow_unused=True)
    hold("head input", order[-1]["dy"], dx)
    tokens = batch["tokens"].reshape(-1)
    for k, dw in zip(rest, dws):
        if k == "embed":
            gather = order[0]["dx"].reshape(tokens.numel(), -1)
            dw = (torch.zeros_like(leaves[k]) if dw is None
                  else dw.clone()).index_add_(0, tokens, gather)
        if dw is None:
            fail(f"{k} takes gradient outside the blocks and the head")
        hold(k, grads[k], dw)
    head_loss = float(head_loss.detach())
    loss_rel = abs(head_loss - float(loss)) / abs(head_loss)
    print(f"{cfg32.name}'s step-0 gradients in fp32, routed, held leaf by "
          f"leaf on their own operands ({len(order)} blocks' backward and "
          f"the head's, each taken again unrouted on the routed run's input "
          f"and output cotangent): worst rel L2 {worst['rel']:.3e} "
          f"({worst['leaf']}) over {len(grads)} leaves and {len(order) + 1} "
          f"input cotangents; the head's loss rel {loss_rel:.2e}; tolerance "
          f"{STEP0_REL}", flush=True)
    if not (worst["rel"] <= STEP0_REL and loss_rel <= STEP0_REL):
        fail(f"the routed fp32 step-0 gradients differ from the unrouted "
             f"ones on their own operands: {worst['rel']:.3e} at "
             f"{worst['leaf']}")
    del order, blocks, grads, params
    return {"block_grad_rel": worst["rel"], "block_grad_leaf": worst["leaf"]}


# the function in which each `state_spans` span of a recurrent stack runs
# its GEMMs: the scans, which sum their einsums in fp32 by design (as the
# reference's `preferred_element_type=float32`)
SCAN_FNS = {"mamba.state": "_ssd_chunked", "mlstm.state": "_mlstm_chunked",
            "slstm.state": "_slstm_scan"}


@contextlib.contextmanager
def scan_arguments(torch, cfg, store: dict):
    """While open, the first call of each of the stack's scans (SCAN_FNS)
    with autograd recording keeps its arguments in `store`, by name."""
    from repro_torch.models import ssm
    reals = {SCAN_FNS[span]: getattr(ssm, SCAN_FNS[span])
             for span in state_spans(cfg) if span in SCAN_FNS}

    def keeping(name, real):
        def kept(*args):
            if name not in store and torch.is_grad_enabled():
                store[name] = args
            return real(*args)
        return kept

    for name, real in reals.items():
        setattr(ssm, name, keeping(name, real))
    try:
        yield store
    finally:
        for name, real in reals.items():
            setattr(ssm, name, real)


REPLAY_ATTEMPTS = 3


def scan_library_gemms(torch, dev, cfg, store: dict) -> int:
    """The fp32 library GEMM kernels a recurrent stack's train step runs in
    its scans: each scan replayed alone under a device profile, on the
    arguments its first layer took in the step (`scan_arguments`: the same
    shapes, strides and dtypes, so the same kernels), forward with autograd
    recording and then backward from its output; a remat step runs each
    layer's forward twice (the pass and the recompute) and its backward
    once. Prints how many windows were replayed, so that a rising rate
    of lost edge kernels shows in the log."""
    from repro_torch.models import ssm
    total, parts, windows, retries = 0, [], 0, 0
    for span, layers in state_spans(cfg).items():
        name = SCAN_FNS[span]
        args = [a.detach().requires_grad_(a.requires_grad)
                if isinstance(a, torch.Tensor) else a for a in store[name]]

        def forward():
            y = getattr(ssm, name)(*args)
            return y[0] if isinstance(y, tuple) else y

        counts = []
        for run in ("forward", "backward"):
            # a replay changes no state, so a window whose profile lost its
            # edge kernels (seen once on the card: all 1000 trailing ones of
            # one of these windows) is replayed, up to REPLAY_ATTEMPTS
            # windows; only a window that kept both edges is counted
            for attempt in range(REPLAY_ATTEMPTS):
                if run == "backward" and attempt:
                    y = forward()        # the graph the last backward freed
                with device_profile(torch, dev) as prof:
                    if run == "forward":
                        y = forward()
                    else:
                        torch.autograd.backward(y, torch.ones_like(y))
                edges = edge_counts(torch, prof)
                windows += 1
                if (edges and all(edges)) or attempt == REPLAY_ATTEMPTS - 1:
                    break
                retries += 1
                print(f"{name} {run} replay: the profile kept {edges} of its "
                      f"edge kernels; replaying", flush=True)
            edge_kernels_kept(torch, prof)
            counts.append(sum(c for _, c, _ in library_gemms(
                device_kernels(torch, prof))[1]))
        per_layer = 2 * counts[0] + counts[1]
        total += layers * per_layer
        parts.append(f"{span} ({name}) {counts[0]} forward x 2 + "
                     f"{counts[1]} backward = {per_layer} a layer x {layers}")
        del y, args
    print(f"the scans' fp32 library GEMMs, each replayed alone on its first "
          f"layer's arguments: {'; '.join(parts)}; {total} a step",
          flush=True)
    print(f"scan replay retries: {retries} of {windows} profiled windows "
          f"(limit {REPLAY_ATTEMPTS} windows a scan and pass)", flush=True)
    return total


def slstm_split(torch, s, state, batch, dev):
    """One more train step with the sLSTM recurrence (`_slstm_scan`, the
    work of the `slstm.state` spans) timed in it: the wall ms of each of
    its calls (each layer's forward and remat recompute) and of each
    layer's backward through it, from the cotangent reaching its output to
    its input's gradient, the device synchronised at each edge (the loop's
    kernels are small: the host bounds it). Returns the state and the
    step's split."""
    from repro_torch.launch import serve
    from repro_torch.models import ssm

    real = ssm._slstm_scan
    forward, backward, opened = [], [], {}

    def timed(pre_all, r, *rest):
        serve._sync(dev)
        t0 = time.perf_counter()
        y, last = real(pre_all, r, *rest)
        serve._sync(dev)
        forward.append((time.perf_counter() - t0) * 1e3)
        key = len(forward)

        def opening(_):
            serve._sync(dev)
            opened[key] = time.perf_counter()

        def closing(_):
            serve._sync(dev)
            backward.append((time.perf_counter() - opened.pop(key)) * 1e3)

        if y.requires_grad and pre_all.requires_grad:
            # hooks on the recompute's tensors never fire: the backward
            # runs the pass's graph
            y.register_hook(opening)
            pre_all.register_hook(closing)
        return y, last

    ssm._slstm_scan = timed
    try:
        serve._sync(dev)
        t0 = time.perf_counter()
        state, _ = s.step_fn(state, batch)
        serve._sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ssm._slstm_scan = real
    n_s = s.cfg.n_layers // s.cfg.slstm_every
    if len(forward) != 2 * n_s or len(backward) != n_s or opened:
        fail(f"timed {len(forward)} sLSTM recurrence calls and "
             f"{len(backward)} backward passes for {n_s} layers")
    slstm_ms = sum(forward) + sum(backward)
    print(f"the sLSTM recurrence (slstm.state) timed in one train step: "
          f"forward {[round(t, 1) for t in forward]} ms (each layer's pass "
          f"and remat recompute), backward {[round(t, 1) for t in backward]} "
          f"ms: {slstm_ms:.1f} ms of the {step_ms:.1f} ms step "
          f"({slstm_ms / step_ms:.1%}), the rest {step_ms - slstm_ms:.1f} ms",
          flush=True)
    return state, {"slstm_step_ms": slstm_ms, "slstm_split_step_ms": step_ms,
                   "slstm_forward_ms": forward,
                   "slstm_backward_ms": backward}


def train_model(torch, mmad_mod, dev, arch_args, cfg=None,
                make_batch=launcher_batch, lr: float = TRAIN_LR,
                keep: dict | None = None):
    """A train phase's main path: a full-width model (as `arch_args` name
    it; `cfg`, when given, its depth cut), three routed steps on one fixed
    batch (`make_batch(torch, setup)`: the launcher's, or one the phase
    builds with a frontend's inputs) at `lr` with per-layer remat, each
    step's expert choices recorded, then held to three unrouted steps that
    take those choices pinned. An MoE model's fp32 router and xLSTM's fp32
    gates run forward on `mmad`'s SIMT tile kernel and backward as fp32
    `torch.matmul`. A stack in FP32_HELD_TRAIN is held instead on fp32
    copies of its weights (`fp32_trajectory`), and every `mmad` call of
    its first bf16 routed step on its own operands (`OperandCheck`).
    Returns the per-step launch count, the backward's per-step launches,
    the per-shape launch table and the numbers the report prints. `keep`,
    when given, receives the routed run's losses, grad norms, launches per
    step and final parameters (a copy in host memory), which the sharded
    phase is held to (`sharded_train`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import flops, serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import shard_ctx
    from repro_torch.obs import build_run_report, render_run_report, set_tracer
    from repro_torch.train import steps

    # the launcher's own setup: plan cache warmed for the train workload
    # (an encoder's and a frontend's shapes included), routing context and
    # tracer installed, step function built
    t0 = time.perf_counter()
    plan_dir = ROOT / "build" / "chip_smoke" / "train_plans"
    shutil.rmtree(plan_dir, ignore_errors=True)
    s = train.setup(train.parse_args(
        arch_args + ["--steps", str(TRAIN_STEPS), "--lr", str(lr),
                     "--plan-cache", str(plan_dir)]), cfg=cfg,
        mesh=make_host_mesh(dev))
    cfg = s.cfg
    moe = bool(cfg.n_experts) and cfg.n_layers > cfg.n_dense_layers
    held32 = s.args.arch in FP32_HELD_TRAIN
    recurrent = cfg.block_pattern in ("mamba2_hybrid", "xlstm")
    batch = make_batch(torch, s)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"train {cfg.name}: {cfg.n_layers} layers, batch {s.args.batch} x "
          f"seq {s.args.seq}"
          + "".join(f", {k} {tuple(v.shape)}" for k, v in batch.items()
                    if k not in ("tokens", "targets"))
          + f", lr {lr}, set up (plans warmed) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # the main path: a fresh routing context and state, counts from zero;
    # the tally records each forward mmad call's shape and operand dtype,
    # and the backward's calls by their forward shape, with the mmad calls
    # they make (the wrapper counts its launches) and the fp32 backward
    # calls that take `torch.matmul` instead
    ctx = serve.install_gemm_context(s.planner, dev)
    tally, bwd_tally, fp32_bwd, dtypes = {}, {}, {}, {}
    real, real_products = ops.mmad, ops.backward_products
    inside = {"backward": 0, "calls": 0, "local_matmul_backward": 0}

    def tallied(a, b, *args, **kw):
        if inside["backward"]:
            inside["calls"] += 1
        else:
            key = (a.shape[0], b.shape[1], a.shape[1])
            tally[key] = tally.get(key, 0) + 1
            dtypes[key] = a.dtype
        return real(a, b, *args, **kw)

    def tallied_products(g, a, b):
        key = (a.shape[0], b.shape[1], a.shape[1])
        bwd_tally[key] = bwd_tally.get(key, 0) + 1
        inside["backward"] += 1
        try:
            return real_products(g, a, b)
        finally:
            inside["backward"] -= 1

    real_backward = ops._LocalMatmul.backward
    real_choice = ops.tensor_core_backward

    def counted_backward(ctx_, g):
        inside["local_matmul_backward"] += 1
        return real_backward(ctx_, g)

    def counted_choice(a, b):
        # the backward's route: two mmad products, or fp32 torch.matmul
        on_mmad = real_choice(a, b)
        if not on_mmad:
            if not a.dtype == b.dtype == torch.float32:
                fail(f"a {a.dtype} x {b.dtype} backward left mmad")
            key = (a.shape[0], b.shape[1], a.shape[1])
            fp32_bwd[key] = fp32_bwd.get(key, 0) + 1
        return on_mmad

    choices = ChoiceLog(torch)      # a dense model records none
    # a stack held in fp32 has its first routed step's mmad calls, forward
    # and backward, held on their own operands (the plain products launch
    # nothing); that step's time is left out of the mean
    operands = OperandCheck(torch, mmad_mod)
    first = {"step": True}

    def step_fn(state, b):
        watch = held32 and first.pop("step", False)
        with operands.watching() if watch else contextlib.nullcontext():
            return s.step_fn(state, b)

    ops.mmad, ops.backward_products = tallied, tallied_products
    ops._LocalMatmul.backward = staticmethod(counted_backward)
    ops.tensor_core_backward = counted_choice
    scans = {}
    mmad_mod.reset_launch_count()
    try:
        with choices.recording(), scan_arguments(torch, cfg, scans):
            state, losses, norms, step_ms = train_steps(
                torch, s, batch, dev, TRAIN_STEPS, step_fn=step_fn)
    finally:
        ops.mmad, ops.backward_products = real, real_products
        ops._LocalMatmul.backward = staticmethod(real_backward)
        ops.tensor_core_backward = real_choice
    launches = mmad_mod.launch_count()
    if keep is not None:
        # on the host, so neither phase's peak holds the copy
        keep.update(losses=list(losses), norms=list(norms),
                    per_step=launches // TRAIN_STEPS,
                    params={n: p.detach().to("cpu", copy=True)
                            for n, p in state[0].named_parameters()})
    stats = ctx.stats
    executed = stats.executed_gemm
    report = build_run_report("train", stats=stats.to_dict(),
                              tracer=s.tracer,
                              extra={"arch": cfg.name,
                                     "steps": TRAIN_STEPS})
    for line in render_run_report(report):
        print(line, flush=True)
    params = state[0]
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{n_params} trainable parameters + fp32 AdamW moments; step ms "
          f"{[round(t, 3) for t in step_ms]}", flush=True)
    with torch.no_grad(), choices.recording():
        losses.append(float(steps.loss_fn(params, batch, cfg)))
    if stats.resolve_rate != 1.0:
        fail(f"train plan-resolve rate {stats.resolve_rate}")
    if stats.silent_degrades:
        fail(f"{stats.silent_degrades} silent degrades in training")
    # every routed dispatch launches once (forward and remat recompute);
    # each forward dispatch's backward call launches its two products,
    # unless its operands are fp32 (the MoE router, xLSTM's gates): that
    # backward is two fp32 torch.matmul products and launches nothing. A
    # frontend's projection runs outside the per-layer remat, once a step
    bwd_calls = sum(bwd_tally.values())
    fp32_calls = sum(fp32_bwd.values())
    unrematted = TRAIN_STEPS if cfg.frontend != "none" else 0
    if executed == 0 or sum(tally.values()) != executed:
        fail(f"{sum(tally.values())} forward mmad calls for {executed} "
             f"routed GEMM dispatches in training")
    if (2 * (bwd_calls + fp32_calls) != executed + unrematted
            or inside["calls"] != 2 * bwd_calls):
        fail(f"{bwd_calls} backward calls made {inside['calls']} mmad calls "
             f"and {fp32_calls} took fp32 torch.matmul, for {executed} "
             f"routed GEMM dispatches ({unrematted} outside the remat)")
    if inside["local_matmul_backward"] != bwd_calls + fp32_calls:
        fail(f"{inside['local_matmul_backward']} local_matmul backward calls "
             f"for {bwd_calls} on mmad and {fp32_calls} in fp32")
    fp32_keys = {k for k, dt in dtypes.items() if dt == torch.float32}
    fp32_tagged = {(sh.m, sh.n, sh.k) for tag, sh in ctx.resolved
                   if tag in FP32_TAGS}
    if not fp32_bwd.keys() == fp32_keys == fp32_tagged:
        fail(f"fp32 backward shapes {sorted(fp32_bwd)} are not the fp32 "
             f"forward's {sorted(fp32_keys)}, the shapes of "
             f"{FP32_TAGS} {sorted(fp32_tagged)}")
    if launches != executed + 2 * bwd_calls or launches % TRAIN_STEPS:
        fail(f"mmad launched {launches} times for {executed} routed GEMM "
             f"dispatches and {bwd_calls} backward calls in training")
    if bwd_tally.keys() | fp32_bwd.keys() != tally.keys():
        fail(f"backward shapes {sorted(bwd_tally)} + {sorted(fp32_bwd)} are "
             f"not the forward's {sorted(tally)}")
    if held32:
        off = [key for key, rec in operands.shapes.items()
               if dev.type == "cuda" and key[0] > mmad_mod.STREAM_MAX_M
               and rec["dtype"] in mmad_mod.WGMMA_DTYPES
               and rec["tensor_core"] != rec["calls"]]
        print(f"the first routed bf16 step's {operands.calls} mmad calls "
              f"(forward, recompute and backward products) held to the "
              f"plain version on their own operands: worst err/tol "
              f"{operands.worst:.3f}", flush=True)
        if operands.calls != launches // TRAIN_STEPS or off:
            fail(f"{operands.calls} mmad calls watched in a step of "
                 f"{launches // TRAIN_STEPS} launches; shapes off the "
                 f"tensor-core kernel: {off}")
        if not operands.worst <= 1.0:
            fail(f"the {cfg.name} train step's mmad calls differ from the "
                 f"plain version on their operands: {operands.worst:.2f}x "
                 f"the tolerance")
    per_step = launches // TRAIN_STEPS
    bwd_per_step = 2 * bwd_calls // TRAIN_STEPS
    shapes = {(sh.m, sh.n, sh.k): sh for _, sh in ctx.resolved
              if hasattr(sh, "m")}
    table = {key: {"block": plan_block(s.planner, ctx, shapes[key],
                                       dtypes[key].itemsize),
                   "count": n // TRAIN_STEPS,
                   "dtype": dtypes[key],
                   "backward_calls": bwd_tally.get(key, 0) // TRAIN_STEPS,
                   "fp32_backward_calls": fp32_bwd.get(key, 0) // TRAIN_STEPS}
             for key, n in tally.items()}
    simt_per_step = sum(r["count"] for r in table.values()
                        if r["dtype"] == torch.float32)
    print(f"train launch census: {executed} routed dispatches (forward + "
          f"remat recompute) launched mmad once each; {bwd_calls} bf16 "
          f"backward calls launched 2 each ({2 * bwd_calls}); {fp32_calls} "
          f"fp32 backward calls (shapes {sorted(fp32_bwd)}) ran on fp32 "
          f"torch.matmul and launched none; total {launches} = "
          f"{executed} + 2 x {bwd_calls}", flush=True)

    scan_fp32 = {}
    if recurrent:
        scan_fp32["scan_fp32"] = scan_library_gemms(torch, dev, cfg, scans)
        scans.clear()
        release(torch)      # the replays' profiler events, before the profile
    prof = train_profile(torch, mmad_mod, s, state, batch, dev, per_step,
                         simt_per_step, fp32_calls // TRAIN_STEPS,
                         **scan_fp32)
    summary = {}
    if cfg.block_pattern == "xlstm":
        release(torch)      # the profile's events, before the timed step
        state, split = slstm_split(torch, s, state, batch, dev)
        summary.update(split)
    shard_ctx.set_gemm_context(None)
    set_tracer(None)
    del state, params
    release(torch)
    if moe:
        flips = choices.same_input_flips()
        summary.update(token_layers=choices.token_layers,
                       same_input_flips=flips)
        print(f"expert choices over the routed run: {flips} of "
              f"{choices.token_layers} token-layers chose otherwise under "
              f"x @ w on the same input (limit "
              f"{TRAIN_SAME_INPUT_FLIP_SHARE:.0e} of them); the unrouted run "
              f"takes the routed run's choices pinned", flush=True)
        if flips > TRAIN_SAME_INPUT_FLIP_SHARE * choices.token_layers:
            fail(f"the mmad router and x @ w chose different experts on the "
                 f"same input for {flips} token-layers")
    choices.inputs.clear()
    if held32:
        # the bf16 routed run must still be finite and fall; the held
        # trajectory is the fp32 copies'
        if not all(math.isfinite(x) for x in losses + norms):
            fail("non-finite loss or grad norm")
        if not losses[-1] < losses[0]:
            fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")
        print(f"the bf16 routed run: losses {losses}, grad norms {norms} "
              f"(finite, falling; not held to an unrouted bf16 run: see "
              f"FP32_HELD_TRAIN)", flush=True)
        check_fp32_trajectory(*fp32_trajectory(torch, s, batch, dev))
        summary.update(block_operand_check(torch, s, batch, dev))
        release(torch)
    else:
        # the yardstick: the same steps unrouted (x @ w, PyTorch's
        # backward), the routed run's expert choices pinned
        with choices.pinned():
            state, ref_losses, ref_norms, _ = train_steps(torch, s, batch,
                                                          dev, TRAIN_STEPS)
            with torch.no_grad():
                ref_losses.append(float(steps.loss_fn(state[0], batch, cfg)))
        del state
        release(torch)
        check_trajectory(losses, norms, ref_losses, ref_norms)
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = s.args.batch * s.args.seq
    model = flops.model_flops(cfg, s.args.batch, s.args.seq, "train")
    summary.update(step_ms=step_ms, mean_step_ms=mean_ms,
                   tokens_per_s=tokens / mean_ms * 1e3,
                   model_tflop=model["total"] / 1e12,
                   model_flops_share=(model["total"] / (mean_ms / 1e3)
                                      / H100_BF16_FLOPS), **prof)
    if dev.type == "cuda":
        summary["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(f"train {cfg.name} on {card}: "
          f"{mean_ms:.3f} ms per step (steps 1-{TRAIN_STEPS - 1}) = "
          f"{summary['tokens_per_s']:.1f} training tokens/s at batch "
          f"{s.args.batch} x seq {s.args.seq}; model FLOPs "
          f"{summary['model_tflop']:.3f} TFLOP a step (launch/flops.py: "
          f"matmul {model['matmul'] / 1e12:.3f}, attention or scan "
          f"{model['attention'] / 1e12:.3f}, sLSTM "
          f"{model['slstm_correction'] / 1e12:.3f}), "
          f"{model['total'] / (mean_ms / 1e3) / 1e12:.1f} TFLOPS = "
          f"{summary['model_flops_share']:.1%} of the bf16 peak; "
          f"{per_step} mmad launches per "
          f"step = {per_step - bwd_per_step} routed GEMM dispatches (forward "
          f"+ remat recompute) + {bwd_per_step} backward products, resolve "
          f"rate {stats.resolve_rate}; peak {summary.get('peak_gb', 0):.2f} "
          f"GB", flush=True)
    return per_step, bwd_per_step, table, summary


# chunked_sdpa against _sdpa on the card: (name, heads, kv heads, head dim,
# sequence). On bf16 q, k, v both take exact products with fp32 sums; the
# chunked form takes them on the tensor cores and rounds each block's
# unnormalised p (and in the backward the cotangent and ds) to bf16 where
# _sdpa rounds the normalised probabilities, and both round out and the
# grads to bf16 (2^-8 relative). Each of out, dq, dk, dv must agree within
# ATTN_TOL of the largest |value| of _sdpa's.
ATTN_CASES = [("gemma-2b", 8, 1, 256, 4096), ("qwen3-14b", 40, 8, 128, 4096),
              ("qwen3-14b", 40, 8, 128, 4000)]
ATTN_TOL = 2e-2


def attention_vs_plain(torch, dev):
    """`chunked_sdpa` (the unfused attention past 1024 tokens) against
    `_sdpa` at b = 1 on bf16 inputs, causal, forward and the grads of q, k
    and v; then the host-paced ms of each, forward and forward + backward,
    beside one `scaled_dot_product_attention` call (PyTorch's fused
    attention, GQA expanded) and the forward's bound; and the peak memory
    each takes above its inputs."""
    import torch.nn.functional as F
    from repro_torch.models.attention import _sdpa, chunked_sdpa

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []
    for name, h, hkv, d, s in ATTN_CASES:
        q, k, v = (torch.randn((1, s, n, d), generator=g, device=dev)
                   .to(torch.bfloat16).requires_grad_(True)
                   for n in (h, hkv, hkv))
        ct = torch.randn((1, s, h, d), generator=g, device=dev).to(
            torch.bfloat16)
        results, peaks = {}, {}
        for label, fn in (("chunked", chunked_sdpa), ("plain", _sdpa)):
            q.grad = k.grad = v.grad = None
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(q, k, v, causal=True)
            out.backward(ct)
            torch.cuda.synchronize(dev)
            peaks[label] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            results[label] = [out.detach()] + [t.grad for t in (q, k, v)]
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max())
                for a, b in zip(results["chunked"], results["plain"])]
        if not all(math.isfinite(e) and e <= ATTN_TOL for e in errs):
            fail(f"chunked_sdpa {name} s={s}: error over max |plain| "
                 f"(out, dq, dk, dv) {errs} exceeds {ATTN_TOL}")
        del results

        def fwd(fn):
            def run():
                with torch.no_grad():
                    fn(q, k, v, causal=True)
            return run

        def fwd_bwd(fn):
            def run():
                q.grad = k.grad = v.grad = None
                fn(q, k, v, causal=True).backward(ct)
            return run

        def library(qq, kk, vv, causal):
            out = F.scaled_dot_product_attention(
                qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=causal, enable_gqa=True)
            return out.transpose(1, 2)

        t_bytes = (2 * s * h * d + 2 * s * hkv * d) * 2 / H100_BYTES_PER_S
        t_ops = 2 * s * s * h * d / H100_BF16_FLOPS    # causal: half of 4
        row = {"case": name, "heads": [h, hkv, d], "seq": s,
               "err_over_max": errs,
               "chunked_ms": wall_ms(torch, fwd(chunked_sdpa), 3, 1),
               "plain_ms": wall_ms(torch, fwd(_sdpa), 3, 1),
               "library_ms": wall_ms(torch, fwd(library), 3, 1),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "chunked_fwd_bwd_ms": wall_ms(torch, fwd_bwd(chunked_sdpa),
                                             3, 1),
               "plain_fwd_bwd_ms": wall_ms(torch, fwd_bwd(_sdpa), 3, 1),
               "library_fwd_bwd_ms": wall_ms(torch, fwd_bwd(library), 3, 1),
               "chunked_peak_gb": peaks["chunked"],
               "plain_peak_gb": peaks["plain"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, ct
        torch.cuda.empty_cache()
    print(f"chunked_sdpa vs _sdpa (causal, bf16, b = 1): {len(rows)} cases "
          f"agree within {ATTN_TOL} of max |plain| in out, dq, dk and dv",
          flush=True)
    return rows


def time_expert_einsums(torch, cfg, dev, seed: int, tokens: int = BATCH,
                        train: bool = False) -> dict:
    """The three expert einsums of one MoE layer at the dispatch geometry of
    `tokens` tokens (`_dp_groups` groups at their capacity; a decode step
    at batch 4 multiplies every expert's gate, up and down weights, as the
    one-hot dispatch does), device ms per step (times the MoE layers)
    beside the bound: reading the weights once and the operations at the
    bf16 peak, whichever is longer. `train` adds the backward (grads of the
    dispatched tokens and of the three weights), timed as forward +
    backward less the forward, beside its bound (the weights read again,
    their grads written, twice the operations)."""
    from repro_torch.models import moe
    from repro_torch.models.common import activation

    g = torch.Generator(device=dev).manual_seed(seed)
    p = moe.Experts(g, cfg, dev)
    groups = moe._dp_groups(tokens)
    cap = moe._capacity(tokens // groups, cfg)
    xe = torch.randn((groups, cfg.n_experts, cap, cfg.d_model), generator=g,
                     device=dev).to(cfg.dtype)

    def experts():
        h = activation(cfg, torch.einsum("gecd,edf->gecf", xe, p.gate),
                       torch.einsum("gecd,edf->gecf", xe, p.up))
        return torch.einsum("gecf,efd->gecd", h, p.down)

    layers = cfg.n_layers - cfg.n_dense_layers
    weight_bytes = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 2
    flops = 2 * 3 * groups * cfg.n_experts * cap * cfg.d_model * cfg.moe_d_ff

    def bound(n_bytes, n_flops):
        t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        t_ops = n_flops / H100_BF16_FLOPS * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    act_bytes = 2 * xe.numel() * 2                  # tokens in, results out
    fwd_bound, fwd_by = bound(weight_bytes + act_bytes, flops)
    with torch.no_grad():
        fwd_ms = device_ms(torch, experts)
    row = {"path": f"{cfg.name} {'train' if train else 'decode'}",
           "einsums": "expert gate, up, down", "groups": groups, "cap": cap,
           "layers": layers, "ms": fwd_ms * layers,
           "bound_ms": fwd_bound * layers, "bound_by": fwd_by}
    if train:
        for t in (xe, p.gate, p.up, p.down):
            t.requires_grad_(True)
        ct = torch.randn(xe.shape, generator=g, device=dev).to(cfg.dtype)

        def fwd_bwd():
            torch.autograd.grad(experts(), (xe, p.gate, p.up, p.down), ct)

        bwd_bound, bwd_by = bound(2 * weight_bytes + 2 * act_bytes,
                                  2 * flops)
        row.update(backward_ms=(device_ms(torch, fwd_bwd, iters=10) - fwd_ms)
                   * layers, backward_bound_ms=bwd_bound * layers,
                   backward_bound_by=bwd_by)
        del ct
    print(json.dumps(row), flush=True)
    del p, xe
    torch.cuda.empty_cache()
    return row


# the dry-run phase: (shape, routed) cells of DRYRUN_ARCH, each its own
# `python -m repro_torch.launch.dryrun` process, both at once. The routed
# cell is a decode cell: a routed train_4k cell cannot warm its planner in
# either package (`model_workload`'s unchunked train lm_head, 1,048,576 x
# 256,000 x 2,048, has no legal schedule on any plan grid).
DRYRUN_ARCH = "gemma-2b"
DRYRUN_CELLS = (("train_4k", False), ("decode_32k", True))
DRYRUN_LIMIT_S = 120.0


def dryrun_cells() -> dict:
    """The dry-run launcher at full configuration on the meta device over
    its fake 16x16 world (no card): a record-only train_4k cell and a
    routed decode_32k cell, run as two processes at once. Asserts each
    status ok; the routed cell's plan-resolve rate 1.0 and no silent
    degrade; `model_workload` fully covered at decode, and at train
    everything but the lm_head, which the loss runs in LOSS_CHUNK-token
    chunks while `model_workload` predicts it whole (a caveat of the
    reference, in both packages); and a useful-FLOP ratio printed. Prints
    each cell's seconds; the phase must end within DRYRUN_LIMIT_S."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.deploy import model_workload
    from repro_torch.launch.input_specs import input_specs
    from repro_torch.train.steps import LOSS_CHUNK

    work = ROOT / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(work, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    (work / "cells").mkdir(parents=True)
    t0 = time.perf_counter()
    procs, logs = {}, {}
    try:
        for shape, routed in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", DRYRUN_ARCH, "--shape", shape, "--plan-cache",
                   str(work / f"plans_{shape}"), "--out", str(work / "cells")]
            logs[shape] = work / f"{shape}.log"
            with open(logs[shape], "w") as log:
                procs[shape] = subprocess.Popen(
                    cmd + (["--route"] if routed else []), env=env,
                    stdout=log, stderr=subprocess.STDOUT)
        seconds = {}
        while len(seconds) < len(procs):
            for shape, proc in procs.items():
                if shape not in seconds and proc.poll() is not None:
                    seconds[shape] = time.perf_counter() - t0
            if time.perf_counter() - t0 > DRYRUN_LIMIT_S:
                fail(f"dryrun cells past {DRYRUN_LIMIT_S:.0f}s")
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cells = {}
    for shape, routed in DRYRUN_CELLS:
        tag = f"{DRYRUN_ARCH}__{shape}__sp" + ("__routed" if routed else "")
        path = work / "cells" / f"{tag}.json"
        if procs[shape].returncode != 0 or not path.exists():
            fail(f"dryrun {shape}: exit {procs[shape].returncode}\n"
                 f"{logs[shape].read_text()[-3000:]}")
        cells[shape] = json.loads(path.read_text())
    cfg = get_config(DRYRUN_ARCH)
    for shape, routed in DRYRUN_CELLS:
        r = cells[shape]
        if r.get("status") != "ok":
            fail(f"dryrun {shape}: status {r.get('status')}: "
                 f"{r.get('error')}")
        w = r["workload"]
        specs = input_specs(cfg, shape)
        predicted = model_workload(cfg, specs["batch"], specs["seq"],
                                   kind=specs["kind"], dp=16)
        missing, extra = w["missing"], w["extra"]
        if specs["kind"] == "train":
            b, s = specs["batch"], specs["seq"]
            want = ([[b * s, cfg.vocab, cfg.d_model]],
                    [[b * LOSS_CHUNK, cfg.vocab, cfg.d_model]])
        else:
            want = ([], [])
        if w["predicted"] != len(predicted) or (missing, extra) != want:
            fail(f"dryrun {shape}: workload {w} (expected missing, extra "
                 f"{want})")
        acc, full = r["accounting"], r["full"]
        line = (f"dryrun {DRYRUN_ARCH} {shape}"
                f"{' routed' if routed else ''}: {seconds[shape]:.1f}s, "
                f"covered {w['covered']:.3f} of {w['predicted']}, "
                f"{full['argument_bytes_per_device'] / 1e9:.3f} GB "
                f"arguments/device, hlo_flops {acc['hlo_flops']:.4g}, "
                f"model_flops {acc['model_flops']:.4g}, useful_ratio "
                f"{acc['useful_ratio']}, roofline dominant "
                f"{(r['roofline'] or {}).get('dominant')}")
        if routed:
            rt = r["routing"]
            if rt["resolve_rate"] != 1.0 or rt["silent_auto_degrades"]:
                fail(f"dryrun {shape} routed: {rt}")
            if r["roofline"] is not None:
                fail(f"dryrun {shape} routed: a rank-0 roofline "
                     f"{r['roofline']}")
            line += (f", resolve_rate {rt['resolve_rate']}, modes "
                     f"{rt['modes']}, collectives {full['collectives']}")
        elif not acc["useful_ratio"]:
            fail(f"dryrun {shape}: no useful_ratio: {acc}")
        print(line, flush=True)
    total = time.perf_counter() - t0
    print(f"dryrun phase {total:.1f}s", flush=True)
    if total > DRYRUN_LIMIT_S:
        fail(f"dryrun phase took {total:.1f}s > {DRYRUN_LIMIT_S:.0f}s")
    return {shape: round(seconds[shape], 1) for shape in seconds}


# The sharded train phase: gemma-2b at full width and depth, its state
# sharded by `spec_rules` (`parallel/sharded.py`) on a DistMesh over an
# NCCL world of one rank, held bitwise to the train phase's routed run;
# then SHARDED_HOST_RANKS gloo processes on the card's host, at smoke
# width in fp32, on SHARDED_HOST_MESHES, held to the port's unsharded
# step. NCCL puts one rank on each card, so the host's CPU ranks are the
# multi-rank evidence here, as in tests/test_torch_sharded_train.py.
SHARDED_HOST_RANKS = 4
SHARDED_HOST_MESHES = {"2x2": ((2, 2), ("data", "model")),
                       "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
SHARDED_HOST_STEPS = 2
SHARDED_HOST_TIMEOUT_S = 300
# The host ranks against the unsharded step on the same host, fp32: each
# step's loss within 1e-5 relative and grad norm within 1e-4 (fp32 sums
# taken in other orders: each pod averages its own rows; the routed modes
# sum their blocks), every parameter within SHARDED_PARAM_ATOL but for at
# most 1 % of each tensor's elements, whose gradient sits at the fp32
# noise floor (Adam steps them about lr x sign(g)); every element of both
# runs within the steps' reach of where it started, 3 x the sum of the
# steps' lr x (1 + weight decay x |p|). An unchanged or wrong tensor,
# however small, fails.
SHARDED_PARAM_ATOL = 1e-5


def sharded_train(torch, mmad_mod, dev, routed: dict, arch_args):
    """The sharded phase's main path: an NCCL world of one rank (gloo in
    the CPU rehearsal), `make_dist_mesh((1, 1))`, and TRAIN_STEPS steps
    through `launch.train.setup(..., mesh=...)` from the train phase's
    weights (seed 0) on its batch, the parameters, AdamW moments and
    plans the launcher's. Every gather is the identity on one rank, so the
    loss, grad norm and final parameters must equal the train phase's
    routed run (`routed`, from `train_model(keep=...)`) bitwise, and its
    `mmad` launches per step too. Then a sharded checkpoint and
    `elastic_reshard` at smoke width (`sharded_checkpoint`), and the host's
    gloo ranks (`host_sharded_run`)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_dist_mesh
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer
    from repro_torch.parallel import sharded, spec_rules

    t0 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store = ROOT / "build" / "chip_smoke" / "sharded_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        mesh = make_dist_mesh((1, 1), dev.type)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        plan_dir = ROOT / "build" / "chip_smoke" / "train_plans"
        s = train.setup(train.parse_args(
            arch_args + ["--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
                         "--plan-cache", str(plan_dir)]), mesh=mesh)
        state = s.init_state()
        batch = launcher_batch(torch, s)
        mmad_mod.reset_launch_count()
        state, losses, norms, step_ms = train_steps(torch, s, batch, dev,
                                                    TRAIN_STEPS, state=state)
        launches = mmad_mod.launch_count()
        stats = s.gemm_ctx.stats
        params = state[0]
        layout = sharded.layout_of(params)
        held = sum(t.numel() * t.element_size() for t in
                   list(params.parameters()) + list(state[1].mu.values())
                   + list(state[1].nu.values()))
        # each parameter's block and its two fp32 moments' blocks
        spec_bytes = sum(
            spec_rules.local_bytes(torch.empty(pl.shape, dtype=dtype,
                                               device="meta"), pl.spec, mesh)
            for n, p in params.named_parameters()
            for pl in [layout.placements[n]]
            for dtype in (p.dtype, torch.float32, torch.float32))
        diff = [n for n, p in params.named_parameters()
                if not torch.equal(p.detach().cpu(), routed["params"][n])]
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else 0.0)
        mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
        print(f"train {s.cfg.name} sharded on a {dict(mesh.shape)} DistMesh "
              f"({backend} world of 1): losses {losses}, grad norms "
              f"{norms} (the train phase's routed run: {routed['losses']}, "
              f"{routed['norms']}); {len(diff)} of "
              f"{len(routed['params'])} parameters differ from its final "
              f"ones; mmad {launches // TRAIN_STEPS} launches per step "
              f"(routed run: {routed['per_step']}); step ms "
              f"{[round(t, 3) for t in step_ms]}; state {held} bytes "
              f"(spec_rules: {spec_bytes}); resolve rate "
              f"{stats.resolve_rate}; peak {peak:.2f} GB", flush=True)
        if losses != routed["losses"] or norms != routed["norms"]:
            fail("the sharded step's losses or grad norms differ from the "
                 "routed train phase's")
        if diff:
            fail(f"the sharded step's final parameters differ: {diff[:5]}")
        if (launches == 0 or launches % TRAIN_STEPS
                or launches // TRAIN_STEPS != routed["per_step"]):
            fail(f"the sharded step launched mmad {launches} times in "
                 f"{TRAIN_STEPS} steps, the routed run "
                 f"{routed['per_step']} a step")
        if held != spec_bytes or stats.resolve_rate != 1.0:
            fail(f"sharded state of {held} bytes (spec_rules: {spec_bytes})"
                 f", resolve rate {stats.resolve_rate}")
        del state, params, layout
        routed["params"].clear()
        if dev.type == "cuda":
            release(torch)
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
        sharded_checkpoint(torch, dev, mesh)
    finally:
        shard_ctx.set_gemm_context(None)
        shard_ctx.set_mesh(None)
        set_tracer(None)
        dist.destroy_process_group()
    host = host_sharded_run(torch)
    seconds = time.perf_counter() - t0
    print(f"sharded phase took {seconds:.1f} s", flush=True)
    return {"launches": launches, "per_step": launches // TRAIN_STEPS,
            "step_ms": step_ms, "mean_step_ms": mean_ms, "peak_gb": peak,
            "host": host, "seconds": seconds}


def sharded_checkpoint(torch, dev, mesh) -> None:
    """A sharded checkpoint at smoke width on `mesh` (the card's world of
    one): one step, a save through `state_shardings`, a restore with them
    into a fresh sharded state, bitwise; `elastic_reshard` onto the same
    mesh hands back the same tensors, and onto a new 1x1 mesh equal
    ones."""
    from repro_torch.ckpt.manager import CheckpointManager, flatten
    from repro_torch.ft import runtime
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_dist_mesh
    from repro_torch.parallel import sharded

    work = ROOT / "build" / "chip_smoke" / "sharded_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    s = train.setup(train.parse_args([
        "--arch", "gemma-2b", "--smoke", "--device", dev.type, "--steps",
        "2", "--batch", "2", "--seq", "32", "--skip-plan-warmup"]),
        mesh=mesh)
    state, _ = s.step_fn(s.init_state(), launcher_batch(torch, s))
    want = [(n, t.clone()) for n, t in flatten(state)]
    mgr = CheckpointManager(str(work))
    mgr.save(0, state, shardings=sharded.state_shardings(state))
    like = s.init_state()
    back = flatten(mgr.restore(0, like, sharded.state_shardings(like)))
    same = flatten(runtime.elastic_reshard(state, mesh))
    moved = flatten(runtime.elastic_reshard(state, make_dist_mesh(
        (1, 1), dev.type)))
    for label, got in (("restored", back), ("re-placed", same),
                       ("re-meshed", moved)):
        bad = [n for (n, a), (m, b) in zip(got, want)
               if n != m or not torch.equal(a, b)]
        if bad or len(got) != len(want):
            fail(f"the {label} sharded state differs: {bad[:5]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"sharded checkpoint at smoke width on {dev}: {len(want)} state "
          f"tensors saved through state_shardings and restored with them, "
          f"and re-placed by elastic_reshard onto the same and a new 1x1 "
          f"mesh, all bitwise", flush=True)


def host_rank(rank: int, world: int, store: str, out_path: str) -> None:
    """One gloo rank of `host_sharded_run` (a spawned process): smoke
    gemma-2b in fp32, SHARDED_HOST_STEPS steps on each mesh, unrouted and
    routed, through `launch.train.setup(..., mesh=...)`; rank 0 writes
    the losses, grad norms and whole parameters."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_dist_mesh
    try:
        meshes = {name: make_dist_mesh(shape, "cpu", axes)
                  for name, (shape, axes) in SHARDED_HOST_MESHES.items()}
        out = {}
        for name, mesh in meshes.items():
            for routed in (False, True):
                out.update(host_case(torch, np, f"{name}/{routed}",
                                     routed, mesh, out_path, rank))
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def host_case(torch, np, key: str, routed: bool, mesh, out_path: str,
              rank: int = 0) -> dict:
    """SHARDED_HOST_STEPS steps of smoke gemma-2b in fp32 on the CPU on
    `mesh` (a DistMesh: sharded; None: the unsharded step); returns its
    losses, grad norms, learning rates, weight decay, and whole parameters
    before (`init`) and after (`params`) the steps, under `key`."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer
    from repro_torch.parallel import sharded

    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=torch.float32)
    s = train.setup(train.parse_args(
        ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch", "4",
         "--seq", "32", "--steps", str(SHARDED_HOST_STEPS), "--lr", "1e-3",
         "--plan-cache", f"{out_path}.plans{rank}"]
        + ([] if routed else ["--skip-plan-warmup"])), cfg=cfg, mesh=mesh)
    state = s.init_state()
    layout = sharded.layout_of(state[0])

    def whole(n, p):
        return (p if layout is None else sharded.gather_data(
            p, layout.placements[n])).detach().numpy().copy()
    out = {f"{key}/init/{n}": whole(n, p)
           for n, p in state[0].named_parameters()}
    losses, norms, lrs = [], [], []
    try:
        for i in range(SHARDED_HOST_STEPS):
            state, m = s.step_fn(state, s.batch_arrays(s.data.batch(i)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
    finally:
        shard_ctx.set_gemm_context(None)
        shard_ctx.set_mesh(None)
        set_tracer(None)
    out.update({f"{key}/loss": np.array(losses), f"{key}/grad_norm":
                np.array(norms), f"{key}/lr": np.array(lrs),
                f"{key}/weight_decay": np.array(s.opt.weight_decay)})
    for n, p in state[0].named_parameters():
        out[f"{key}/params/{n}"] = whole(n, p)
    return out


def host_sharded_run(torch) -> dict:
    """SHARDED_HOST_RANKS gloo processes on this host (spawned; CPU only)
    train smoke gemma-2b sharded on SHARDED_HOST_MESHES, unrouted and
    routed; this process runs the unsharded step, unrouted and routed,
    and holds each sharded run to it (SHARDED_PARAM_ATOL)."""
    import numpy as np

    work = ROOT / "build" / "chip_smoke" / "sharded_host"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out_path = str(work / "ranks.npz")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=host_rank, args=(
        r, SHARDED_HOST_RANKS, str(work / "store"), out_path))
        for r in range(SHARDED_HOST_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_HOST_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * SHARDED_HOST_RANKS:
        fail(f"the host's sharded ranks exited with {codes}")
    ranks_s = time.perf_counter() - t0
    got = dict(np.load(out_path))
    want = {}
    for routed in (False, True):
        want.update(host_case(torch, np, f"whole/{routed}", routed, None,
                              out_path))
    rows = {}
    for name in SHARDED_HOST_MESHES:
        for routed in (False, True):
            key, ref = f"{name}/{routed}", f"whole/{routed}"
            rel_loss = float(np.max(np.abs(got[key + "/loss"]
                                           - want[ref + "/loss"])
                                    / want[ref + "/loss"]))
            rel_norm = float(np.max(np.abs(got[key + "/grad_norm"]
                                           - want[ref + "/grad_norm"])
                                    / want[ref + "/grad_norm"]))
            names = [k[len(ref + "/params/"):] for k in want
                     if k.startswith(ref + "/params/")]
            lr_sum = float(np.sum(want[ref + "/lr"]))
            wd = float(want[ref + "/weight_decay"])
            apart = 0
            worst = 0.0
            crowded, strayed = [], []
            for n in names:
                p0 = want[f"{ref}/init/{n}"]
                new_s = got[f"{key}/params/{n}"]
                new_w = want[f"{ref}/params/{n}"]
                reach = 3 * lr_sum * (1 + wd * np.abs(p0)) + 1e-7
                if not all((np.abs(new - p0) <= reach).all()
                           for new in (new_s, new_w)):
                    strayed.append(n)
                err = np.abs(new_s - new_w)
                worst = max(worst, float(err.max()))
                n_apart = int((err > SHARDED_PARAM_ATOL).sum())
                apart += n_apart
                if n_apart > 0.01 * err.size:
                    crowded.append(n)
            rows[key] = {"loss_rel": rel_loss, "grad_norm_rel": rel_norm,
                         "param_max_abs": worst, "params_apart": apart}
            if not (rel_loss <= 1e-5 and rel_norm <= 1e-4
                    and not crowded and not strayed):
                fail(f"the host's sharded step on {key} left the unsharded "
                     f"one: {rows[key]}; tensors with over 1 % of their "
                     f"elements past {SHARDED_PARAM_ATOL}: {crowded[:5]}; "
                     f"out of the steps' reach: {strayed[:5]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"host: {SHARDED_HOST_RANKS} gloo ranks at smoke width (fp32) on "
          f"{list(SHARDED_HOST_MESHES)} (unrouted / routed) against the "
          f"unsharded step, {SHARDED_HOST_STEPS} steps: "
          + "; ".join(f"{k}: loss rel {v['loss_rel']:.1e}, grad norm rel "
                      f"{v['grad_norm_rel']:.1e}, params max "
                      f"{v['param_max_abs']:.1e} ({v['params_apart']} "
                      f"elements past {SHARDED_PARAM_ATOL})"
                      for k, v in rows.items())
          + f"; the ranks took {ranks_s:.1f} s", flush=True)
    return rows


def release(torch) -> None:
    """Free what a phase left on the card before the next one."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def path_entry(name: str, path: str, launches: int, rows) -> dict:
    """One `kernels` entry for `mmad` on a decode path: the step's launches
    and, per step, the timed shapes' sums."""
    def per_step(key):
        return sum(r[key] * r["launches_per_step"] for r in rows)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmad.cu",
        "replaces": "src/repro/kernels/mmad.py:80", "path": path,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step("kernel_ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": per_step("library_ms")}


def train_args(arch: str):
    """The train phases' launcher flags (the config's depth cut, if any,
    goes to `launch.train.setup` as a config: the launcher has no depth
    flag; the phases pass the mesh: the card's 1x1 `HostMesh`, or the
    sharded phase's `DistMesh`, in place of the production mesh these
    flags, without `--smoke`, would name)."""
    return ["--arch", arch, "--device", "cuda", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ)]


def train_path_entry(name: str, path: str, launches: int, rows,
                     simt_key: str = "simt_router") -> dict:
    """One `kernels` entry for `mmad` on a train path: the run's launches
    and, per step, the timed shapes' forward sums (each shape times its
    launches) plus their backward's (each shape's two products times its
    backward calls; an fp32 shape has none on `mmad`), with the fp32
    row on the SIMT tile kernel (the MoE router, xLSTM's gates) apart,
    under `simt_key`."""
    def fwd(key):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    def bwd(key):
        return sum(r[key] * r["backward_calls_per_step"] for r in rows
                   if r["backward_calls_per_step"])

    simt = [r for r in rows if r["dtype"] == "float32"]
    entry = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmad.cu",
        "replaces": "src/repro/kernels/mmad.py:80", "path": path,
        "launches": launches,
        "max_abs_err": max(max(r["max_abs_err"],
                               r.get("backward_max_abs_err", 0.0))
                           for r in rows),
        "forward_ms": fwd("kernel_ms"), "forward_bound_ms": fwd("bound_ms"),
        "forward_plain_ms": fwd("plain_ms"),
        "forward_library_ms": fwd("library_ms"),
        "backward_ms": bwd("backward_ms"),
        "backward_bound_ms": bwd("backward_bound_ms"),
        "backward_plain_ms": bwd("backward_plain_ms"),
        "backward_library_ms": bwd("backward_library_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        simt_key: ({k: simt[0][k] for k in (
            "shape", "variant", "launches_per_step", "kernel_ms", "bound_ms",
            "plain_ms", "library_ms", "fp32_backward_matmul_ms",
            "fp32_backward_bound_ms", "fp32_backward_calls_per_step")}
            if simt else None)}
    for key in ("ms", "bound_ms", "plain_ms", "library_ms"):
        entry[key] = entry[f"forward_{key}"] + entry[f"backward_{key}"]
    return entry


# the other families' train phases, after the MoE one: (arch, layers, or
# None for full depth, and the batch)
TRAIN_PHASES = [
    ("zamba2-1.2b", None, launcher_batch, TRAIN_LR),
    ("xlstm-1.3b", XLSTM_TRAIN_LAYERS, launcher_batch, XLSTM_TRAIN_LR),
    ("seamless-m4t-medium", None, frontend_batch, TRAIN_LR),
    ("phi-3-vision-4.2b", PHI3_TRAIN_LAYERS, frontend_batch, PHI3_TRAIN_LR)]


def print_train_path(label: str, launches: int, summary: dict, entry: dict,
                     extra: str = "") -> None:
    """One report line for a train path: the step's ms, tokens/s, model
    FLOP rate, peak, `mmad` forward and backward against their bounds and
    `torch.matmul`, the device busy share."""
    print(f"train {label} (batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): "
          f"{summary['mean_step_ms']:.3f} ms per step = "
          f"{summary['tokens_per_s']:.1f} training tokens/s, model FLOPs "
          f"{summary['model_tflop']:.3f} TFLOP a step = "
          f"{summary['model_flops_share']:.1%} of the bf16 peak, peak "
          f"{summary['peak_gb']:.2f} GB; mmad {launches} launches per step, "
          f"forward {entry['forward_ms']:.3f} ms (bound "
          f"{entry['forward_bound_ms']:.3f}, torch.matmul "
          f"{entry['forward_library_ms']:.3f}), backward "
          f"{entry['backward_ms']:.3f} ms (bound "
          f"{entry['backward_bound_ms']:.3f}, bf16 torch.matmul "
          f"{entry['backward_library_ms']:.3f}){extra}; device busy share "
          f"{summary['busy_ms'] / summary['wall_ms']:.1%}", flush=True)


def simt_text(row: dict, what: str) -> str:
    """The report's words on a train path's fp32 row (SIMT tile kernel
    forward, fp32 `torch.matmul` backward)."""
    return (f"; the fp32 {what} {row['shape']} on the SIMT tile kernel "
            f"{row['kernel_ms']:.4f} ms a launch x "
            f"{row['launches_per_step']} (bound {row['bound_ms']:.4f}, fp32 "
            f"torch.matmul {row['library_ms']:.4f}), its backward on fp32 "
            f"torch.matmul {row['fp32_backward_matmul_ms']:.4f} ms a call x "
            f"{row['fp32_backward_calls_per_step']} (bound "
            f"{row['fp32_backward_bound_ms']:.4f})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # plain versions and the unrouted yardstick in full fp32 / fp32-reduced
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build, ref
    import importlib
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")

    phase("device")
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib, seconds = build.build("mmad")
    print(f"built {lib.name} in {seconds:.1f}s "
          f"(phase {time.perf_counter() - t0:.1f}s)", flush=True)

    phase("kernels vs plain")
    check_kernels(torch, mmad_mod, ref)

    phase("serve gemma-2b")
    from repro_torch.configs import get_config
    cfg = get_config("gemma-2b")
    dev = torch.device("cuda")
    launches, per_step, _ = serve_model(torch, mmad_mod, cfg, dev)
    release(torch)

    phase("train")
    routed_run = {}
    train_launches, train_bwd_launches, train_table, train_summary = \
        train_model(torch, mmad_mod, dev, train_args("gemma-2b"),
                    keep=routed_run)
    resume_check(torch, dev)
    release(torch)

    phase("train gemma-2b sharded")
    sharded_summary = sharded_train(torch, mmad_mod, dev, routed_run,
                                    train_args("gemma-2b"))
    del routed_run
    release(torch)

    # serve --traffic: mode -> what `serve_traffic` returns
    traffic = {}
    for i, mode in enumerate(TRAFFIC_MODES):
        phase(f"serve {TRAFFIC_ARCH} --traffic [{mode}]")
        traffic[mode] = serve_traffic(torch, mmad_mod, dev, mode,
                                      fresh=i == 0)
        release(torch)

    served, served_cfgs = {}, {}
    for arch in ("deepseek-moe-16b", "qwen3-14b"):
        phase(f"serve {arch}")
        served_cfgs[arch] = get_config(arch)
        served[arch] = serve_model(torch, mmad_mod, served_cfgs[arch], dev)
        release(torch)

    arch = "deepseek-v2-236b"
    phase(f"serve {arch} ({SERVE_V2_LAYERS} layers)")
    v2 = served_cfgs[arch] = dataclasses.replace(get_config(arch),
                                                 n_layers=SERVE_V2_LAYERS)
    served[arch] = serve_model(
        torch, mmad_mod, v2, dev,
        after=lambda params, planner, prompts: naive_vs_absorbed(
            torch, mmad_mod, v2, dev, params, planner, prompts))
    release(torch)

    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        phase(f"serve {arch}")
        ssm_cfg = served_cfgs[arch] = get_config(arch)
        served[arch] = serve_model(
            torch, mmad_mod, ssm_cfg, dev,
            after=lambda params, planner, prompts, c=ssm_cfg:
            chunked_vs_recurrent(torch, mmad_mod, c, dev, params, planner))
        release(torch)

    # the frontend models, each with its forward check on the same weights
    forward_tables = {}
    for arch, check in (("seamless-m4t-medium", encoder_vs_decode),
                        ("phi-3-vision-4.2b", prefix_forward)):
        phase(f"serve {arch}")
        front_cfg = served_cfgs[arch] = get_config(arch)
        served[arch] = serve_model(
            torch, mmad_mod, front_cfg, dev,
            after=lambda params, planner, prompts, c=front_cfg, f=check:
            f(torch, mmad_mod, c, dev, params, planner, prompts))
        forward_tables[arch] = served[arch][2].pop("forward_table")
        release(torch)

    arch = "deepseek-moe-16b"
    phase(f"train {arch} ({MOE_TRAIN_LAYERS} layers)")
    moe_cfg = dataclasses.replace(get_config(arch), n_layers=MOE_TRAIN_LAYERS)
    moe_launches, _, moe_table, moe_summary = train_model(
        torch, mmad_mod, dev, train_args(arch), cfg=moe_cfg)
    release(torch)

    # MLA's naive form in a backward, and the other families: arch ->
    # (config, launches per step, backward launches per step, launch table,
    # summary)
    trained = {}
    arch = "deepseek-v2-236b"
    phase(f"train {arch} ({V2_TRAIN_LAYERS} layers)")
    v2_train = dataclasses.replace(get_config(arch), n_layers=V2_TRAIN_LAYERS)
    trained[arch] = (v2_train, *train_model(torch, mmad_mod, dev,
                                            train_args(arch), cfg=v2_train))
    release(torch)
    for arch, layers, make_batch, lr in TRAIN_PHASES:
        full = get_config(arch)
        train_cfg = (full if layers is None
                     else dataclasses.replace(full, n_layers=layers))
        phase(f"train {arch}" + (f" ({layers} layers)" if layers else ""))
        trained[arch] = (train_cfg, *train_model(
            torch, mmad_mod, dev, train_args(arch),
            cfg=None if layers is None else train_cfg,
            make_batch=make_batch, lr=lr))
        release(torch)

    phase("chunked_sdpa vs plain")
    attn_rows = attention_vs_plain(torch, dev)
    release(torch)

    phase("dryrun")
    dryrun_cells()

    # times below are per gemma-2b decode step at batch 4, and per train
    # step at batch 2 x seq 1024: the sum over the step's launches of each
    # shape's time
    phase("kernel timing")
    rows = time_shapes(torch, mmad_mod, ref, cfg, per_step, dev, SEED + 1)
    train_rows = time_shapes(torch, mmad_mod, ref, cfg, train_table, dev,
                             SEED + 2, kind="train")
    path_rows = {arch: time_shapes(torch, mmad_mod, ref, served_cfgs[arch],
                                   table, dev, SEED + 4 + i)
                 for i, (arch, (_, table, _)) in enumerate(served.items())}
    forward_rows = {arch: time_shapes(torch, mmad_mod, ref,
                                      served_cfgs[arch], table, dev,
                                      SEED + 10 + i, kind="forward")
                    for i, (arch, table) in enumerate(forward_tables.items())}
    moe_rows = time_shapes(torch, mmad_mod, ref, moe_cfg, moe_table, dev,
                           SEED + 8, kind="train")
    trained_rows = {arch: time_shapes(torch, mmad_mod, ref, train_cfg, table,
                                      dev, SEED + 20 + i, kind="train")
                    for i, (arch, (train_cfg, _, _, table, _))
                    in enumerate(trained.items())}
    experts_rows = {arch: time_expert_einsums(torch, served_cfgs[arch], dev,
                                              SEED + 6)
                    for arch in ("deepseek-moe-16b", "deepseek-v2-236b")}
    moe_experts = time_expert_einsums(torch, moe_cfg, dev, SEED + 9,
                                      tokens=TRAIN_BATCH * TRAIN_SEQ,
                                      train=True)
    # every distinct shape of both traffic replays, once, held to the plain
    # version on random operands as the dispatch lays them out (an untied
    # (k, n) weight, lm_head too)
    traffic_table = {}
    for summary in traffic.values():
        traffic_table.update(summary["table"])
    traffic_rows = time_shapes(
        torch, mmad_mod, ref, dataclasses.replace(cfg, tie_embeddings=False),
        traffic_table, dev, SEED + 31, kind="traffic")

    def per_step_ms(key, rows=rows):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    train_ms = per_step_ms("kernel_ms", train_rows)
    train_bound = per_step_ms("bound_ms", train_rows)
    train_library = per_step_ms("library_ms", train_rows)

    def backward_per_step(key):
        return sum(r[key] * r["backward_calls_per_step"] for r in train_rows)

    backward_ms = backward_per_step("backward_ms")
    backward_bound = backward_per_step("backward_bound_ms")
    backward_library = backward_per_step("backward_library_ms")
    train_flops = sum(2 * math.prod(r["shape"]) * r["launches_per_step"]
                      for r in train_rows)
    print(f"train step (gemma-2b, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): "
          f"{train_summary['mean_step_ms']:.3f} ms = "
          f"{train_summary['tokens_per_s']:.1f} training tokens/s; mmad "
          f"{train_launches - train_bwd_launches} forward launches, "
          f"{train_flops / 1e12:.3f} TFLOP, "
          f"{train_ms:.3f} ms from the timed shapes "
          f"({train_flops / train_ms / 1e9:.1f} TFLOPS; forward and "
          f"backward {train_summary['mmad_ms']:.3f} ms in the profiled "
          f"step) against a bound of "
          f"{train_bound:.3f} ms (share {train_bound / train_ms:.1%}) and "
          f"torch.matmul's {train_library:.3f} ms; the backward's mmad "
          f"{train_bwd_launches} launches, {backward_ms:.3f} ms against a "
          f"bound of {backward_bound:.3f} ms (share "
          f"{backward_bound / backward_ms:.1%}) and bf16 torch.matmul's "
          f"{backward_library:.3f} ms; device busy share "
          f"{train_summary['busy_ms'] / train_summary['wall_ms']:.1%}",
          flush=True)

    for arch, (arch_launches, _, summary) in served.items():
        rows_ = path_rows[arch]
        entry = path_entry("mmad", arch, arch_launches, rows_)
        experts_row = experts_rows.get(arch)
        einsums = (f"; the MoE einsums {summary['moe_einsums_ms']:.3f} ms "
                   f"per step in the profile, the expert einsums "
                   f"{experts_row['ms']:.3f} ms timed against a bound of "
                   f"{experts_row['bound_ms']:.3f} ms"
                   if experts_row else "")
        if arch in forward_rows:
            fwd = path_entry("mmad", arch, 0, forward_rows[arch])
            held = (f"the routed forward against the decode, rel L2 "
                    f"{summary['encoder_decode_rel_l2']:.3e}"
                    if "encoder_decode_rel_l2" in summary else
                    f"the routed prefix forward against the unrouted one, "
                    f"rel L2 {summary['prefix_rel_l2']:.3e}")
            einsums = (f"; first step routed vs unrouted rel L2 "
                       f"{summary['first_step_rel_l2']:.3e}, {held}; the "
                       f"forward's mmad {fwd['ms']:.3f} ms from the timed "
                       f"shapes against a bound of {fwd['bound_ms']:.3f} ms "
                       f"(share {fwd['bound_ms'] / fwd['ms']:.1%}) and "
                       f"torch.matmul's {fwd['library_ms']:.3f} ms")
        if served_cfgs[arch].block_pattern != "attn":
            einsums = "; the state updates " + ", ".join(
                f"{name} {summary[span_key(name)]:.3f} ms"
                for name in state_spans(served_cfgs[arch])) + (
                f" per step in the profile (step busy "
                f"{summary['step_busy_ms']:.3f} ms, mmad "
                f"{summary['step_mmad_ms']:.3f} ms); chunked vs recurrent "
                f"rel L2 {summary['chunked_recurrent_rel_l2']:.3e}")
        print(f"decode {arch} (batch {BATCH}): {summary['tok_s']:.1f} tok/s "
              f"({summary['step_ms']:.3f} ms per step); mmad "
              f"{arch_launches // (PROMPT + GEN)} launches per step, "
              f"{entry['ms']:.3f} ms from the timed shapes against a bound "
              f"of {entry['bound_ms']:.3f} ms (share "
              f"{entry['bound_ms'] / entry['ms']:.1%}) and torch.matmul's "
              f"{entry['library_ms']:.3f} ms ({summary['mmad_ms']:.3f} ms "
              f"in the profile, {summary['tensor_core_per_step']:.0f} "
              f"tensor-core launches a step){einsums}; device busy share "
              f"{summary['busy_ms'] / summary['wall_ms']:.1%}; plan warm-up "
              f"{summary['warmup_s']:.2f}s; peak {summary['peak_gb']:.2f} GB",
              flush=True)
    moe_entry = train_path_entry("mmad/deepseek-moe-16b-train",
                                 f"deepseek-moe-16b train, {MOE_TRAIN_LAYERS} "
                                 f"layers, batch {TRAIN_BATCH} x seq "
                                 f"{TRAIN_SEQ}", moe_launches * TRAIN_STEPS,
                                 moe_rows)
    print_train_path(f"deepseek-moe-16b ({MOE_TRAIN_LAYERS} layers)",
                     moe_launches, moe_summary, moe_entry,
                     simt_text(moe_entry["simt_router"], "router")
                     + f"; the expert einsums forward {moe_experts['ms']:.3f} "
                     f"ms (bound {moe_experts['bound_ms']:.3f}), backward "
                     f"{moe_experts['backward_ms']:.3f} ms (bound "
                     f"{moe_experts['backward_bound_ms']:.3f})")
    sharded_entry = train_path_entry(
        "mmad/gemma-2b-train-sharded",
        f"gemma-2b train, state sharded by spec_rules on a 1x1 DistMesh "
        f"(NCCL world of 1), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}",
        sharded_summary["launches"], train_rows)
    print(f"train gemma-2b sharded (1x1 DistMesh, NCCL world of 1, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}): "
          f"{sharded_summary['mean_step_ms']:.3f} ms per step (the train "
          f"phase's routed run: {train_summary['mean_step_ms']:.3f}), peak "
          f"{sharded_summary['peak_gb']:.2f} GB; mmad "
          f"{sharded_summary['per_step']} launches per step, forward "
          f"{sharded_entry['forward_ms']:.3f} ms (bound "
          f"{sharded_entry['forward_bound_ms']:.3f}, torch.matmul "
          f"{sharded_entry['forward_library_ms']:.3f}), backward "
          f"{sharded_entry['backward_ms']:.3f} ms (bound "
          f"{sharded_entry['backward_bound_ms']:.3f}, bf16 torch.matmul "
          f"{sharded_entry['backward_library_ms']:.3f}) from the train "
          f"shapes' timings; the phase took "
          f"{sharded_summary['seconds']:.1f} s", flush=True)
    trained_entries = []
    for arch, (train_cfg, per_step_, _, _, summary) in trained.items():
        cut = train_cfg != get_config(arch)
        depth = f", {train_cfg.n_layers} layers" if cut else ""
        fp32_what = "router" if train_cfg.n_experts else "gates"
        entry = train_path_entry(
            f"mmad/{arch}-train", f"{arch} train{depth}, batch {TRAIN_BATCH} "
            f"x seq {TRAIN_SEQ}", per_step_ * TRAIN_STEPS, trained_rows[arch],
            simt_key=f"simt_{fp32_what}")
        trained_entries.append(entry)
        extra = (simt_text(entry[f"simt_{fp32_what}"], fp32_what)
                 if entry[f"simt_{fp32_what}"] else "")
        if "slstm_step_ms" in summary:
            extra += (f"; the sLSTM recurrence {summary['slstm_step_ms']:.1f}"
                      f" ms of a {summary['slstm_split_step_ms']:.1f} ms "
                      f"step")
        print_train_path(arch + (f" ({train_cfg.n_layers} layers)"
                                 if cut else ""),
                         per_step_, summary, entry, extra)
    traffic_entries = []
    for mode, summary in traffic.items():
        shapes = {key[:3] for key in summary["table"]}
        rows_ = [r for r in traffic_rows if tuple(r["shape"]) in shapes]
        entry = path_entry(f"mmad/{TRAFFIC_ARCH}-traffic-{mode}",
                           f"{TRAFFIC_ARCH} serve --traffic, {mode} "
                           f"admission, each distinct shape once",
                           summary["launches"], rows_)
        traffic_entries.append(entry)
        section = summary["serving"]
        by_m = {}
        for r in rows_:
            by_m.setdefault((r["shape"][0], route_name(mmad_mod,
                                                       r["variant"])),
                            []).append(r)
        for (m, name), rs in sorted(by_m.items()):
            print(f"traffic [{mode}] M = {m}: {name}, {len(rs)} shapes "
                  f"{sum(r['kernel_ms'] for r in rs) * 1e3:.1f} us (bound "
                  f"{sum(r['bound_ms'] for r in rs) * 1e3:.1f}, "
                  f"torch.matmul "
                  f"{sum(r['library_ms'] for r in rs) * 1e3:.1f})",
                  flush=True)
        print(f"serve {TRAFFIC_ARCH} --traffic [{mode}]: virtual clock (the "
              f"cost model's, not the card's time) goodput "
              f"{section['goodput_tps']:.1f} tok/s, p99 latency "
              f"{section['p99_latency_s'] * 1e3:.3f} ms, "
              f"{section['distinct_shapes']} distinct shapes; on the card "
              f"mmad {summary['launches']} launches, one a shape, "
              f"{entry['ms']:.3f} ms over the timed shapes against a bound "
              f"of {entry['bound_ms']:.3f} ms (share "
              f"{entry['bound_ms'] / entry['ms']:.1%}) and torch.matmul's "
              f"{entry['library_ms']:.3f} ms; serve.main took "
              f"{summary['seconds']:.2f} s", flush=True)
    print(json.dumps({"chunked_sdpa": attn_rows, "moe_expert_einsums":
                      list(experts_rows.values()) + [moe_experts]}),
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "mmad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmad.cu",
        "replaces": "src/repro/kernels/mmad.py:80",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step_ms("kernel_ms"),
        "plain_ms": per_step_ms("plain_ms"),
        "bound_ms": per_step_ms("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": per_step_ms("library_ms"),
        "train_launches": train_launches,
        "train_ms": train_ms,
        "train_plain_ms": per_step_ms("plain_ms", train_rows),
        "train_bound_ms": train_bound,
        "train_bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                          for r in train_rows)
                           else "operations"),
        "train_library_ms": train_library,
        "train_max_abs_err": max(r["max_abs_err"] for r in train_rows),
        "train_backward_launches": train_bwd_launches,
        "train_backward_ms": backward_ms,
        "train_backward_plain_ms": backward_per_step("backward_plain_ms"),
        "train_backward_bound_ms": backward_bound,
        "train_backward_bound_by": (
            "bytes" if all(r["backward_bound_by"] == "bytes"
                           for r in train_rows) else "operations"),
        "train_backward_library_ms": backward_library,
        "train_backward_max_abs_err": max(r["backward_max_abs_err"]
                                          for r in train_rows),
    }] + [path_entry(f"mmad/{arch}", f"{arch} decode, batch {BATCH}"
                     + (f", {served_cfgs[arch].n_layers} layers"
                        if served_cfgs[arch] != get_config(arch) else ""),
                     served[arch][0], rows_)
          for arch, rows_ in path_rows.items()] + [
        path_entry(f"mmad/{arch}-forward",
                   f"{arch} forward with its frontend inputs, batch {BATCH}",
                   served[arch][2].get("encoder_launches",
                                       served[arch][2].get("prefix_launches")),
                   rows_)
        for arch, rows_ in forward_rows.items()] + [moe_entry]
        + trained_entries + traffic_entries + [sharded_entry]}), flush=True)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - T_START:.1f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
