"""Plain reference of the train cell: a DeepSeekMoE language model's train
step in float32 (PyTorch operations only, TF32 off), from the weights and
batches the benchmark makes, written from the published description
(arXiv:2401.06066 and the model's `config.json`) and the configuration
file's stated semantics: the configuration as run, its published keys
with its `departures` (what the port does otherwise) laid over them
(`as_run`). It imports nothing of the program.

The model: token embedding; `n_dense_layers` dense blocks, then MoE
blocks; each block pre-norm (RMSNorm, eps `rms_norm_eps`) multi-head
causal attention with rotary embeddings (rotate-half, base `rope_theta`)
and a residual, then pre-norm SwiGLU MLP (dense) or MoE with a residual;
a final RMSNorm and the untied head; the loss is the mean next-token
cross-entropy. The MoE layer: a softmax router in float32 over the routed
experts, the top `moe_top_k` by score (ties to the lower index), their
weights renormalised to sum to one where `norm_topk_prob` says so, tokens
dispatched in groups of `dispatch_group_tokens` with `capacity_factor`
slots per expert and group, a (token, choice) pair past its expert's
capacity dropped in token order, plus the shared experts as one SwiGLU MLP
of `moe_d_ff * n_shared_experts`. AdamW: global-norm clipping, bias-corrected
moments in float32, decoupled weight decay, linear warm-up then cosine
decay, each update rounded once to the parameter's stored dtype.

Leaves are named and laid out as the program takes them: a projection is
(d_in, d_out) and applied as x @ w; the routed experts are stacked
(experts, d_in, d_out).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.harness.core import derive_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# leaves and weights
# ---------------------------------------------------------------------------

def as_run(config: Dict) -> Dict:
    """The configuration as the cell runs it: the file's keys, with its
    `departures` from the published model laid over them."""
    return {**config, **config.get("departures", {})}


def diff_leaves(c: Dict, pattern: str) -> List[str]:
    """The leaves whose first clipped gradient is compared element by
    element: those whose name `pattern` matches from its start."""
    return [name for name, _, _ in leaves(c) if re.match(pattern, name)]


def leaves(c: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, stored dtype) of every parameter."""
    d, hd, bf, f32 = c["hidden_size"], c["head_dim"], "bfloat16", "float32"
    attn = [("attn.wq", (d, c["num_attention_heads"] * hd), bf),
            ("attn.wk", (d, c["num_key_value_heads"] * hd), bf),
            ("attn.wv", (d, c["num_key_value_heads"] * hd), bf),
            ("attn.wo", (c["num_attention_heads"] * hd, d), bf)]
    norms = [("ln1.scale", (d,), f32), ("ln2.scale", (d,), f32)]
    out = [("embed", (c["vocab_size"], d), bf)]
    for i in range(c["first_k_dense_replace"]):
        for name, shape, dt in norms + attn + [
                ("mlp.gate", (d, c["intermediate_size"]), bf),
                ("mlp.up", (d, c["intermediate_size"]), bf),
                ("mlp.down", (c["intermediate_size"], d), bf)]:
            out.append((f"dense_layers.{i}.{name}", shape, dt))
    e, f = c["n_routed_experts"], c["moe_intermediate_size"]
    sh = f * c["n_shared_experts"]
    for i in range(c["num_hidden_layers"] - c["first_k_dense_replace"]):
        for name, shape, dt in norms + attn + [
                ("moe.router", (d, e), f32),
                ("moe.experts.gate", (e, d, f), bf),
                ("moe.experts.up", (e, d, f), bf),
                ("moe.experts.down", (e, f, d), bf),
                ("moe.shared.gate", (d, sh), bf),
                ("moe.shared.up", (d, sh), bf),
                ("moe.shared.down", (sh, d), bf)]:
            out.append((f"moe_layers.{i}.{name}", shape, dt))
    out += [("ln_f.scale", (d,), f32), ("lm_head", (d, c["vocab_size"]), bf)]
    return out


def make_leaf(c: Dict, seed: int, name: str, shape, dtype: str, device
              ) -> torch.Tensor:
    """One leaf from the seed: a norm's scale is ones, every other leaf
    normal with the configuration's `initializer_range`, drawn in float32
    on `device` by a generator of its own and rounded to its dtype."""
    if len(shape) == 1:
        return torch.ones(shape, dtype=DTYPES[dtype], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, f"weight:{name}"))
    x = torch.randn(shape, generator=gen, device=device)
    return x.mul_(c["initializer_range"]).to(DTYPES[dtype])


def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {name: make_leaf(c, seed, name, shape, dt, device)
            for name, shape, dt in leaves(c)}


def make_batches(c: Dict, traffic: Dict, seed: int, device):
    """The feed: a fresh batch of tokens drawn uniformly from the
    vocabulary on each call, from one generator seeded from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "batches"))
    b, s = traffic["batch"], traffic["seq"]
    while True:
        x = torch.randint(0, c["vocab_size"], (b, s + 1), generator=gen,
                          device=device)
        yield {"tokens": x[:, :-1], "targets": x[:, 1:]}


# ---------------------------------------------------------------------------
# matmuls: float32, or the control's e4m3 (one scale a tensor, the incoming
# gradients quantized too)
# ---------------------------------------------------------------------------

def _e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / x.detach().abs().max().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _E4m3Matmul(torch.autograd.Function):
    """x @ w on operands quantized to e4m3 with one scale a tensor, the
    incoming gradient quantized likewise in the backward's two products."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _e4m3(x), _e4m3(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _e4m3(g)
        dx = gq @ wq.transpose(-1, -2)
        dw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


def fp32_mm(x, w):
    return x @ w


def e4m3_mm(x, w):
    return _E4m3Matmul.apply(x, w)


MATMULS = {"float32": fp32_mm, "e4m3": e4m3_mm}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model:
    def __init__(self, c: Dict, params: Dict[str, torch.Tensor],
                 mm: Callable = fp32_mm):
        self.c, self.p, self.mm = c, params, mm

    def rmsnorm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.c["rms_norm_eps"]) * scale

    def rope(self, x):
        b, s, h, d = x.shape
        inv = self.c["rope_theta"] ** (-torch.arange(0, d, 2, device=x.device,
                                                     dtype=torch.float64) / d)
        ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] \
            * inv
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, h, pre):
        c, p, mm = self.c, self.p, self.mm
        b, s, _ = h.shape
        hd, nh = c["head_dim"], c["num_attention_heads"]
        nkv = c["num_key_value_heads"]
        q = self.rope(mm(h, p[pre + "attn.wq"]).view(b, s, nh, hd))
        k = self.rope(mm(h, p[pre + "attn.wk"]).view(b, s, nkv, hd))
        v = mm(h, p[pre + "attn.wv"]).view(b, s, nkv, hd)
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
        return mm(out, p[pre + "attn.wo"])

    def swiglu(self, x, gate, up, down):
        mm = self.mm
        return mm(F.silu(mm(x, gate)) * mm(x, up), down)

    def route(self, xt, router):
        """(weights, experts) of each token's top-k choices."""
        k = self.c["num_experts_per_tok"]
        gates = torch.softmax(xt @ router, dim=-1)
        topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
        topv, topi = topv[:, :k], topi[:, :k]
        if self.c["norm_topk_prob"]:
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        return topv, topi

    def kept(self, topi):
        """Whether each (token, choice) fits its expert's capacity in its
        dispatch group, pairs taken in token order then choice order. The
        tokens split into the most groups, a power of two in number, that
        leave each at least `dispatch_group_tokens` (one group where none
        can)."""
        c = self.c
        t, k = topi.shape
        groups = 1
        while t % (2 * groups) == 0 and \
                t // (2 * groups) >= c["dispatch_group_tokens"]:
            groups *= 2
        tl = t // groups
        cap = max(int(tl * k * c["capacity_factor"]
                      / c["n_routed_experts"]), 4)
        pairs = topi.reshape(t // tl, tl * k)
        onehot = F.one_hot(pairs, c["n_routed_experts"])
        pos = (onehot.cumsum(1) * onehot).sum(-1) - 1
        return (pos < cap).reshape(t, k)

    def moe(self, h, pre):
        c, p, mm = self.c, self.p, self.mm
        b, s, d = h.shape
        xt = h.reshape(b * s, d)
        topv, topi = self.route(xt, p[pre + "moe.router"])
        keep = self.kept(topi)
        out = torch.zeros_like(xt)
        gate, up, down = (p[pre + "moe.experts.gate"],
                          p[pre + "moe.experts.up"],
                          p[pre + "moe.experts.down"])
        for e in range(c["n_routed_experts"]):
            tok, choice = torch.nonzero((topi == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.swiglu(xt[tok], gate[e], up[e], down[e])
            out = out.index_add(0, tok, y * topv[tok, choice][:, None])
        out = out + self.swiglu(xt, p[pre + "moe.shared.gate"],
                                p[pre + "moe.shared.up"],
                                p[pre + "moe.shared.down"])
        return out.reshape(b, s, d)

    def layer(self, x, pre, moe: bool):
        p = self.p
        x = x + self.attention(self.rmsnorm(x, p[pre + "ln1.scale"]), pre)
        h = self.rmsnorm(x, p[pre + "ln2.scale"])
        if moe:
            return x + self.moe(h, pre)
        return x + self.swiglu(h, p[pre + "mlp.gate"], p[pre + "mlp.up"],
                               p[pre + "mlp.down"])

    def loss(self, tokens, targets):
        c, p = self.c, self.p
        x = p["embed"][tokens]
        layers = [(f"dense_layers.{i}.", False)
                  for i in range(c["first_k_dense_replace"])]
        layers += [(f"moe_layers.{i}.", True)
                   for i in range(c["num_hidden_layers"]
                                  - c["first_k_dense_replace"])]
        for pre, moe in layers:
            x = checkpoint(self.layer, x, pre, moe, use_reentrant=False)
        x = self.rmsnorm(x, p["ln_f.scale"])
        total = torch.zeros((), device=x.device)
        chunk = min(c["loss_chunk"], x.shape[1])
        for i in range(0, x.shape[1], chunk):
            total = total + checkpoint(self._xent, x[:, i:i + chunk],
                                       targets[:, i:i + chunk],
                                       use_reentrant=False)
        return total / targets.numel()

    def _xent(self, h, t):
        logits = self.mm(h, self.p["lm_head"])
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, t[..., None])[..., 0]).sum()


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def lr_at(o: Dict, step: int) -> float:
    warm = min((step + 1) / max(1, o["warmup_steps"]), 1.0)
    frac = min(max((step - o["warmup_steps"])
                   / max(1, o["total_steps"] - o["warmup_steps"]), 0.0), 1.0)
    return o["lr"] * warm * 0.5 * (1 + math.cos(math.pi * frac))


def train(c: Dict, o: Dict, weights: Dict[str, torch.Tensor],
          batches: Sequence[Dict[str, torch.Tensor]],
          precision: str = "float32",
          rows: Optional[slice] = None, keep: Sequence[str] = ()) -> Dict:
    """Train `weights` (consumed: updated in place in their stored dtypes)
    on `batches` in order; return the readings the cell compares: each
    step's loss, each leaf's norm of the first step's clipped gradient
    (as the optimizer takes it), and that gradient of the leaves named in
    `keep`, read back from the first moment after one step as the
    program's is, in float32 on the host. `precision` is `float32` or the
    control's `e4m3`; `rows` keeps only those rows of each batch (a
    fault)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu = {n: torch.zeros(w.shape, device=w.device) for n, w in
              weights.items()}
        nu = {n: torch.zeros(w.shape, device=w.device) for n, w in
              weights.items()}
        losses, first, first_grads = [], {}, {}
        for step, batch in enumerate(batches, start=1):
            params = {n: w.to(torch.float32, copy=True).requires_grad_(True)
                      for n, w in weights.items()}
            model = Model(c, params, MATMULS[precision])
            tok, tgt = batch["tokens"], batch["targets"]
            if rows is not None:
                tok, tgt = tok[rows], tgt[rows]
            loss = model.loss(tok, tgt)
            loss.backward()
            losses.append(float(loss.detach()))
            grads = {n: p.grad for n, p in params.items()}
            del params, model, loss
            first_step = adamw_update(o, step, weights, grads, mu, nu)
            if step == 1:
                first = first_step
                first_grads = first_moment_grads(mu, keep, o["b1"])
        return {"losses": losses, "first_grad_norms": first,
                "first_grads": first_grads}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def adamw_update(o: Dict, step: int, weights: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                 nu: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """AdamW step `step` (from 1) in place: the gradients clipped by their
    global norm, the moments and the update in float32, each weight
    rounded once to its stored dtype. Consumes `grads`; returns each
    leaf's norm of its clipped gradient."""
    norm = math.sqrt(sum(float(torch.linalg.vector_norm(
        g, dtype=torch.float64)) ** 2 for g in grads.values()))
    factor = min(1.0, o["clip_norm"] / (norm + 1e-9))
    lr = lr_at(o, step)
    b1c, b2c = 1 - o["b1"] ** step, 1 - o["b2"] ** step
    clipped = {}
    for n, w in weights.items():
        g = grads.pop(n).float() * factor
        clipped[n] = float(torch.linalg.vector_norm(g))
        m = mu[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
        v = nu[n].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
        pf = w.float()
        upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"]) \
            + o["weight_decay"] * pf
        w.copy_((pf - lr * upd).to(w.dtype))
        del g, pf, upd
    return clipped


def first_moment_grads(mu: Dict[str, torch.Tensor], keep: Sequence[str],
                       b1: float) -> Dict[str, torch.Tensor]:
    """The first step's clipped gradient of each leaf in `keep`, from the
    first moment after that step (mu = (1 - b1) g), in float32 on the
    host."""
    return {n: mu[n].to("cpu", torch.float32, copy=True).div_(1 - b1)
            for n in keep}


def change_norms(c: Dict, seed: int, weights: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each leaf's norm of its change from its initial values, which are
    drawn again from the seed leaf by leaf."""
    out = {}
    for name, shape, dt in leaves(c):
        w0 = make_leaf(c, seed, name, shape, dt, weights[name].device)
        out[name] = float(torch.linalg.vector_norm(
            weights[name].float() - w0.float()))
        del w0
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a train cell compares, program against reference: the
    largest relative gap of a step's loss; the worst leaf's gap of the
    first-gradient norms and of the change norms, each leaf's gap over the
    larger of the reference's norm of that leaf and of the median leaf;
    and, over the leaves whose first gradient both keep, the worst leaf's
    norm of the difference of the two first gradients over the norm of
    the reference's (`grad_diff`, each leaf's in `grad_diff_by_leaf`).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    g_ref = ref["first_grad_norms"]
    g_med = _median(g_ref.values())
    grad = [abs(prog["first_grad_norms"][n] - r) / max(r, g_med)
            for n, r in g_ref.items()]
    moved = [n for n, r in g_ref.items() if r >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = _median(c_ref[n] for n in moved)
    change = [abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med)
              for n in moved]
    by_leaf = {n: _rel_diff(prog["first_grads"][n], r)
               for n, r in ref["first_grads"].items()
               if n in prog["first_grads"]}
    return {"loss_gap": loss, "grad_norm_gap": _worst(grad),
            "change_norm_gap": _worst(change),
            "grad_diff": _worst(by_leaf.values()),
            "grad_diff_by_leaf": by_leaf}


def _worst(xs) -> float:
    """The largest of `xs`; NaN where one is NaN, or where there is none."""
    xs = list(xs)
    return math.nan if not xs or any(map(math.isnan, xs)) else max(xs)


def _rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| over |want|; NaN where `got` holds a value that is not
    finite."""
    if not bool(torch.isfinite(got).all()):
        return math.nan
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])
