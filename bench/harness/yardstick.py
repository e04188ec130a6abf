"""The benchmark's frozen arithmetic: the card's data-sheet peaks, a
GEMM's operations, bytes and least time, the train step's model FLOPs and
its routed GEMMs, all from a configuration's widths. Nothing here reads the
program, so a change to the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

# NVIDIA H100 SXM data sheet, dense (no sparsity) rates at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float8_e4m3fn": 1979e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float8_e4m3fn": 1, "float32": 4}


class Gemm(NamedTuple):
    """One product C (m, n) = A (m, k) @ B (k, n): A and B in `dtype`, C in
    `out_dtype`."""
    m: int
    n: int
    k: int
    dtype: str
    out_dtype: str

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.k

    @property
    def bytes(self) -> float:
        """A, B and C once each, at their dtypes."""
        return float((self.m * self.k + self.k * self.n)
                     * ELEM_BYTES[self.dtype]
                     + self.m * self.n * ELEM_BYTES[self.out_dtype])

    @property
    def least_s(self) -> float:
        """The least time the card could take: the larger of operations
        over the dtype's peak and bytes over the HBM bandwidth."""
        return max(self.flops / PEAK_FLOPS[self.dtype],
                   self.bytes / HBM_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        return ("operations" if self.flops / PEAK_FLOPS[self.dtype]
                >= self.bytes / HBM_BYTES_PER_S else "bytes")


def gemm_round(ms: List[int], nk: List[List[int]], dtype: str) -> List[Gemm]:
    """One round of a GEMM cell: every (n, k) at every m, in that order,
    C in the operands' dtype (what `dit_gemm` returns)."""
    return [Gemm(m, n, k, dtype, dtype) for m in ms for n, k in nk]


# ---------------------------------------------------------------------------
# the train step: a frozen copy of the port's `launch/flops.py` arithmetic
# for an attention stack (dense layers, then MoE layers), on a
# configuration file's widths
# ---------------------------------------------------------------------------

def _attn_params(c: Dict) -> int:
    hd = c["head_dim"]
    return (c["hidden_size"] * c["num_attention_heads"] * hd
            + 2 * c["hidden_size"] * c["num_key_value_heads"] * hd
            + c["num_attention_heads"] * hd * c["hidden_size"])


def param_count(c: Dict) -> int:
    """Every parameter of the model: embedding, the untied head, the final
    norm, each dense layer (two norms, attention, the gated MLP) and each
    MoE layer (two norms, attention, the router, the routed experts'
    gate, up and down, the shared experts as one gated MLP)."""
    d, v = c["hidden_size"], c["vocab_size"]
    total = v * d + (0 if c["tie_word_embeddings"] else d * v) + d
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    dense = 2 * d + _attn_params(c) + 3 * d * c["intermediate_size"]
    moe = (2 * d + _attn_params(c) + d * c["n_routed_experts"]
           + 3 * c["n_routed_experts"] * d * c["moe_intermediate_size"]
           + 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"])
    return total + c["first_k_dense_replace"] * dense + n_moe * moe


def active_params_excl_embed(c: Dict) -> int:
    """Parameters a token touches (MoE: the shared and top-k experts
    only), less the embedding table; the untied head stays counted."""
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    inactive = ((c["n_routed_experts"] - c["num_experts_per_tok"]) * 3
                * c["hidden_size"] * c["moe_intermediate_size"] * n_moe)
    return param_count(c) - inactive - c["vocab_size"] * c["hidden_size"]


def train_flops(c: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N D over active parameters, plus
    attention scores at 12 B S^2 H hd a layer (no causal halving, as the
    port's `launch/flops.py` counts them)."""
    attn = (12.0 * batch * seq * seq * c["num_attention_heads"]
            * c["head_dim"] * c["num_hidden_layers"])
    return 6.0 * active_params_excl_embed(c) * batch * seq + attn


def train_gemms(c: Dict, batch: int, seq: int, loss_chunk: int
                ) -> List[Gemm]:
    """The routed GEMMs of one forward pass of the train step (each layer's
    projections, the MoE router in fp32 and the shared experts, the loss
    chunks' head), from the configuration's widths. The routed experts'
    einsums are not among them."""
    d, t, hd = c["hidden_size"], batch * seq, c["head_dim"]
    bf, f32 = "bfloat16", "float32"
    attn = [Gemm(t, c["num_attention_heads"] * hd, d, bf, bf),
            Gemm(t, c["num_key_value_heads"] * hd, d, bf, bf),
            Gemm(t, c["num_key_value_heads"] * hd, d, bf, bf),
            Gemm(t, d, c["num_attention_heads"] * hd, bf, bf)]
    dense = attn + [Gemm(t, c["intermediate_size"], d, bf, bf)] * 2 \
        + [Gemm(t, d, c["intermediate_size"], bf, bf)]
    shared = c["moe_intermediate_size"] * c["n_shared_experts"]
    moe = attn + [Gemm(t, c["n_routed_experts"], d, f32, f32)] \
        + [Gemm(t, shared, d, bf, bf)] * 2 + [Gemm(t, d, shared, bf, bf)]
    chunk = min(loss_chunk, seq)
    head = [Gemm(batch * chunk, c["vocab_size"], d, bf, bf)] * (seq // chunk)
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return dense * c["first_k_dense_replace"] + moe * n_moe + head


def backward_gemms(g: Gemm) -> List[Gemm]:
    """The two products of a GEMM's backward: dA = dC @ B^T and
    dB = A^T @ dC, each out in its operand's dtype."""
    return [Gemm(g.m, g.k, g.n, g.dtype, g.dtype),
            Gemm(g.k, g.n, g.m, g.dtype, g.dtype)]
