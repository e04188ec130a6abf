"""Each plain reference against a float64 NumPy computation at tiny
sizes."""
import math

import numpy as np
import pytest
import torch

from bench.reference import gemm as gref, moe_lm
from bench.tests._tiny import tiny_train


def test_exact_product_and_c_error():
    g = torch.Generator().manual_seed(3)
    a = torch.randn(300, 70, generator=g).to(torch.bfloat16)
    w = torch.randn(70, 50, generator=g).to(torch.bfloat16)
    c = (a.float() @ w.float()).to(torch.bfloat16)
    exact = a.double().numpy() @ w.double().numpy()
    want = np.abs(c.double().numpy() - exact).max() / np.sqrt(
        (exact ** 2).mean())
    assert gref.c_error(c, a, w) == pytest.approx(want, rel=1e-12)
    bad = c.clone()
    bad[0, 0] = float("nan")
    assert math.isnan(gref.c_error(bad, a, w))


def test_controls_round_below_the_operands():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(5, 33, generator=g)
    xn = x.double().numpy()
    s = np.abs(xn).max(1, keepdims=True) / 7
    assert np.allclose(gref.int4_rows(x).numpy(),
                       np.clip(np.round(xn / s), -8, 7) * s)
    e = gref.e4m3_tensor(x).numpy()
    assert np.abs(e - xn).max() <= np.abs(xn).max() / 16     # 3 bits
    assert len(np.unique(np.round(gref.int4_rows(x)[0].numpy(), 12))) <= 16
    a = x.to(torch.float8_e4m3fn)
    assert gref.control_c(a, a).dtype == torch.float8_e4m3fn


def _np_loss(c, w, tokens, targets):
    w = {k: v.double().numpy() for k, v in w.items()}
    eps, hd = c["rms_norm_eps"], c["head_dim"]
    nh, e, k = c["num_attention_heads"], c["n_routed_experts"], \
        c["num_experts_per_tok"]

    def rms(x, s):
        return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * s

    def rope(x):
        s, d = x.shape[1], x.shape[-1]
        ang = np.arange(s)[:, None] * c["rope_theta"] ** (
            -np.arange(0, d, 2) / d)
        cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def silu(x):
        return x / (1 + np.exp(-x))

    def mlp(x, g, u, d):
        return (silu(x @ g) * (x @ u)) @ d

    x = w["embed"][tokens]
    b, s, dm = x.shape
    for i in range(c["num_hidden_layers"]):
        moe = i >= c["first_k_dense_replace"]
        p = (f"moe_layers.{i - c['first_k_dense_replace']}." if moe
             else f"dense_layers.{i}.")
        h = rms(x, w[p + "ln1.scale"])
        q = rope((h @ w[p + "attn.wq"]).reshape(b, s, nh, hd))
        kk = rope((h @ w[p + "attn.wk"]).reshape(b, s, nh, hd))
        v = (h @ w[p + "attn.wv"]).reshape(b, s, nh, hd)
        sc = np.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
        sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        o = np.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, s, nh * hd)
        x = x + o @ w[p + "attn.wo"]
        h = rms(x, w[p + "ln2.scale"])
        if not moe:
            x = x + mlp(h, w[p + "mlp.gate"], w[p + "mlp.up"],
                        w[p + "mlp.down"])
            continue
        xt = h.reshape(b * s, dm)
        t = b * s
        groups = 1
        while t % (2 * groups) == 0 and \
                t // (2 * groups) >= c["dispatch_group_tokens"]:
            groups *= 2
        tl = t // groups
        cap = max(int(tl * k * c["capacity_factor"] / e), 4)
        out = np.zeros_like(xt)
        for g0 in range(0, t, tl):
            used = [0] * e
            for tok in range(g0, g0 + tl):
                z = xt[tok] @ w[p + "moe.router"]
                gates = np.exp(z - z.max())
                gates /= gates.sum()
                top = np.argsort(-gates, kind="stable")[:k]
                wt = gates[top] / gates[top].sum()
                for ex, wgt in zip(top, wt):
                    if used[ex] < cap:
                        out[tok] += wgt * mlp(
                            xt[tok], w[p + "moe.experts.gate"][ex],
                            w[p + "moe.experts.up"][ex],
                            w[p + "moe.experts.down"][ex])
                    used[ex] += 1
        out += mlp(xt, w[p + "moe.shared.gate"], w[p + "moe.shared.up"],
                   w[p + "moe.shared.down"])
        x = x + out.reshape(b, s, dm)
    x = rms(x, w["ln_f.scale"])
    logits = x @ w["lm_head"]
    mx = logits.max(-1, keepdims=True)
    lse = np.log(np.exp(logits - mx).sum(-1)) + mx[..., 0]
    gold = np.take_along_axis(logits, targets[..., None], -1)[..., 0]
    return float((lse - gold).mean())


@pytest.mark.parametrize("group_tokens", [512, 16])
def test_moe_lm_loss_against_numpy_float64(group_tokens):
    """`group_tokens` 16 splits the tokens into groups whose capacity drops
    pairs."""
    _, c = tiny_train()
    c = dict(moe_lm.as_run(c), dispatch_group_tokens=group_tokens,
             initializer_range=0.2)
    weights = moe_lm.make_weights(c, 5, "cpu")
    batch = next(moe_lm.make_batches(c, {"batch": 2, "seq": 32}, 5, "cpu"))
    params = {n: x.float() for n, x in weights.items()}
    got = float(moe_lm.Model(c, params).loss(batch["tokens"],
                                              batch["targets"]))
    want = _np_loss(c, weights, batch["tokens"].numpy(),
                    batch["targets"].numpy())
    assert got == pytest.approx(want, rel=2e-6)


def test_adamw_update_against_numpy_float64():
    o = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
             clip_norm=1.0, warmup_steps=5, total_steps=100)
    g = torch.Generator().manual_seed(6)
    w = {"a": torch.randn(40, generator=g), "b": torch.randn(3, 7,
                                                             generator=g)}
    w0 = {n: x.double().numpy().copy() for n, x in w.items()}
    mu = {n: torch.zeros_like(x) for n, x in w.items()}
    nu = {n: torch.zeros_like(x) for n, x in w.items()}
    m = {n: np.zeros_like(x) for n, x in w0.items()}
    v = {n: np.zeros_like(x) for n, x in w0.items()}
    for step in (1, 2):
        grads = {n: torch.randn(x.shape, generator=g) for n, x in w.items()}
        gn = {n: x.double().numpy() for n, x in grads.items()}
        norm = math.sqrt(sum((x ** 2).sum() for x in gn.values()))
        f = min(1.0, 1.0 / (norm + 1e-9))
        warm = min((step + 1) / 5, 1.0)
        lr = 1e-2 * warm * 0.5 * (1 + math.cos(math.pi * max(
            (step - 5) / 95, 0.0)))
        first = moe_lm.adamw_update(o, step, w, grads, mu, nu)
        for n in w0:
            gg = gn[n] * f
            assert first[n] == pytest.approx(np.linalg.norm(gg), rel=1e-6)
            m[n] = 0.9 * m[n] + 0.1 * gg
            v[n] = 0.95 * v[n] + 0.05 * gg * gg
            upd = (m[n] / (1 - 0.9 ** step)) / (
                np.sqrt(v[n] / (1 - 0.95 ** step)) + 1e-8) + 0.01 * w0[n]
            w0[n] = w0[n] - lr * upd
            assert np.allclose(w[n].numpy(), w0[n], rtol=1e-6, atol=1e-7)


def test_lr_schedule():
    o = dict(lr=1e-4, warmup_steps=5, total_steps=100)
    assert moe_lm.lr_at(o, 1) == pytest.approx(4e-5)
    assert moe_lm.lr_at(o, 4) == pytest.approx(1e-4)
    assert moe_lm.lr_at(o, 100) == pytest.approx(0.0, abs=1e-20)
