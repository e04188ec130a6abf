"""Tiny cells for the CPU tests: the real cells' files, shrunk."""
from bench.harness import core

TRAIN = "dsmoe16b-train-b4s1024"


def tiny_train(batch=2, seq=64, **sizes):
    """The train cell at 3 layers of 8 experts, top 2; `sizes` replaces
    any of the configuration's sizes."""
    cell = core.load_json("workloads", TRAIN)
    cell["traffic"].update(batch=batch, seq=seq)
    config = dict(core.load_json("configs", "deepseek-moe-16b"),
                  hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=4, head_dim=16, intermediate_size=160,
                  moe_intermediate_size=48, n_routed_experts=8,
                  num_experts_per_tok=2, num_hidden_layers=3, vocab_size=256)
    config.update(sizes)
    return cell, config


def tiny_gemm(name, nk=((96, 128), (64, 256)), ms=None):
    cell = core.load_json("workloads", name)
    if ms is not None:
        cell["traffic"]["m"] = list(ms)
    config = dict(core.load_json("configs", cell["config"]),
                  gemms=[list(x) for x in nk])
    return cell, config
