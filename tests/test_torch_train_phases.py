"""CPU rehearsals of `chip_smoke.py`'s train phases of zamba2-1.2b,
xlstm-1.3b, seamless-m4t-medium, phi-3-vision-4.2b and the dense families
olmo-1b, phi4-mini-3.8b and qwen3-14b, at smoke width.

Each runs `chip_smoke.train_model` as the card phase does, with CPU
tensors and the verify skill's stubs (`ops.mmad` counted, since the CPU
path counts no launches; the tensor-core backward taken for bf16 operands,
so the census holds as on the card; the device profile stubbed): the
launcher's setup (its plan warm-up covers the encoder's, the
cross-attention's and the frontend's shapes: resolve rate 1.0), three
routed steps with per-layer remat, launches = routed dispatches + 2 per
bf16 backward call, and the trajectory held as on the card. The
recurrent stacks run two SSD / mLSTM chunks (seq 256). xlstm-1.3b is
held on fp32 copies of its weights (`chip_smoke.FP32_HELD_TRAIN`), its
first bf16 step's `mmad` calls on their own operands, its fp32 gates
counted apart (SIMT tile forward, fp32 `torch.matmul` backward), its
step-0 fp32 gradients held leaf by leaf on their own operands, and its
sLSTM recurrence timed in a step. The frontend models take `frontend_batch`:
the launcher's tokens plus random frames or patches at `FRONTEND_SCALE`.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from test_torch_serve import ROOT  # noqa: E402


def _chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("chip_smoke")


def _rehearse(monkeypatch, tmp_path, arch, seq, make_batch):
    """`chip_smoke.train_model` on the smoke model with CPU tensors and the
    stubs above; returns what it returns and the arguments it handed the
    stubbed profile after its step's launches."""
    chip_smoke = _chip_smoke(monkeypatch)
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import ops
    from repro_torch.obs import set_tracer
    real = ops.mmad

    def counted(a, b, *args, **kw):
        mmad_mod._launches += 1
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ops, "mmad", counted)
    monkeypatch.setattr(ops, "tensor_core_backward",
                        lambda a, b: a.dtype == b.dtype == torch.bfloat16)
    profiled, replayed = [], []
    monkeypatch.setattr(chip_smoke, "train_profile", lambda *a, **k: (
        profiled.append((a[6:], k)) or {"busy_ms": 1, "wall_ms": 1,
                                         "mmad_ms": 0}))
    # the scans' replay census needs the card's profile: it sees the
    # arguments the step's scans took, and counts SCAN_GEMMS
    monkeypatch.setattr(chip_smoke, "scan_library_gemms", lambda *a: (
        replayed.append({k: len(v) for k, v in a[3].items()}) or SCAN_GEMMS))
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    try:
        out = chip_smoke.train_model(
            torch, mmad_mod, torch.device("cpu"),
            ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
             "--seq", str(seq)],
            make_batch=getattr(chip_smoke, make_batch))
    finally:
        tctx.set_gemm_context(None)
        set_tracer(None)
    assert len(profiled) == 1
    return chip_smoke, out, profiled[0], replayed


SCAN_GEMMS = 7


def test_the_phases_train_every_registered_family(monkeypatch):
    """TRAIN_PHASES and the gemma-2b and MoE phases before them train
    every registered architecture on the card."""
    chip_smoke = _chip_smoke(monkeypatch)
    phases = {arch: (layers, batch.__name__)
              for arch, layers, batch, _ in chip_smoke.TRAIN_PHASES}
    assert phases == {
        "zamba2-1.2b": (None, "launcher_batch"),
        "xlstm-1.3b": (chip_smoke.XLSTM_TRAIN_LAYERS, "launcher_batch"),
        "seamless-m4t-medium": (None, "frontend_batch"),
        "phi-3-vision-4.2b": (chip_smoke.PHI3_TRAIN_LAYERS,
                              "frontend_batch"),
        "olmo-1b": (None, "launcher_batch"),
        "phi4-mini-3.8b": (None, "launcher_batch"),
        "qwen3-14b": (chip_smoke.QWEN3_TRAIN_LAYERS, "launcher_batch")}
    assert set(phases) | {"gemma-2b", "deepseek-moe-16b",
                          "deepseek-v2-236b"} == set(tconfigs.list_archs())
    assert chip_smoke.PHI3_TRAIN_LAYERS in (16, 32)
    assert chip_smoke.XLSTM_TRAIN_LAYERS % 8 == 0     # whole super-layers
    assert 4 <= chip_smoke.QWEN3_TRAIN_LAYERS < 40
    assert set(chip_smoke.FP32_HELD_TRAIN) <= set(phases)
    assert all(0 < lr <= 1e-3 for *_, lr in chip_smoke.TRAIN_PHASES)


def _gemms(cfg, arch):
    """Routed GEMM dispatches of one forward of the smoke model (one loss
    chunk: seq <= 512)."""
    if arch == "zamba2-1.2b":
        n_super = cfg.n_layers // cfg.hybrid_attn_every
        return 2 * cfg.n_layers + 7 * n_super + 1
    if arch == "xlstm-1.3b":
        n_s = cfg.n_layers // cfg.slstm_every
        return 6 * (cfg.n_layers - n_s) + 2 * n_s + 1
    if arch == "seamless-m4t-medium":
        # frontend; encoder layers' q/k/v/o + gated MLP (gate, up, down);
        # decoder layers' self q/k/v/o, cross q/k/v/o, MLP; lm_head
        return 1 + 7 * cfg.n_encoder_layers + 11 * cfg.n_layers + 1
    if arch == "phi-3-vision-4.2b":
        return 1 + 7 * cfg.n_layers + 1       # frontend.proj
    return 7 * cfg.n_layers + 1               # the dense families


CASES = [("zamba2-1.2b", 256, "launcher_batch"),
         ("xlstm-1.3b", 256, "launcher_batch"),
         ("seamless-m4t-medium", 64, "frontend_batch"),
         ("phi-3-vision-4.2b", 64, "frontend_batch"),
         ("olmo-1b", 64, "launcher_batch"),
         ("phi4-mini-3.8b", 64, "launcher_batch"),
         ("qwen3-14b", 64, "launcher_batch")]


@pytest.mark.parametrize("arch,seq,make_batch", CASES,
                         ids=[c[0] for c in CASES])
def test_chip_smoke_train_phase_rehearsed_on_cpu(arch, seq, make_batch,
                                                 monkeypatch, tmp_path,
                                                 capsys):
    chip_smoke, (per_step, bwd_per_step, table, summary), (args, kw), \
        replayed = _rehearse(monkeypatch, tmp_path, arch, seq, make_batch)
    out = capsys.readouterr().out
    cfg = tconfigs.smoke_config(arch)
    dispatches = _gemms(cfg, arch)
    fp32 = [r for r in table.values() if r["dtype"] == torch.float32]
    fp32_calls = sum(r["count"] for r in fp32) // 2
    # the forward's dispatches run again in the remat recompute, but for a
    # frontend's projection
    once = int(cfg.frontend != "none")
    assert per_step == 2 * dispatches - once + 2 * (dispatches - fp32_calls)
    assert bwd_per_step == 2 * (dispatches - fp32_calls)
    assert 2 * sum(r["backward_calls"] for r in table.values()) == \
        bwd_per_step
    recurrent = arch in ("zamba2-1.2b", "xlstm-1.3b")
    # the profile counts the recurrent stacks' scans' fp32 library GEMMs
    # apart: each scan replayed alone on the arguments of its first call
    # (the SSD's 5, the mLSTM's 5, the sLSTM's 6)
    assert args == (per_step, 2 * fp32_calls, fp32_calls)
    assert kw == ({"scan_fp32": SCAN_GEMMS} if recurrent else {})
    assert replayed == ([] if not recurrent
                        else [{"_ssd_chunked": 5}] if arch == "zamba2-1.2b"
                        else [{"_mlstm_chunked": 5, "_slstm_scan": 6}])
    if arch == "xlstm-1.3b":
        # the fp32 gates: forward and recompute on the SIMT tile kernel,
        # one fp32 backward call each mLSTM layer
        n_m = cfg.n_layers - cfg.n_layers // cfg.slstm_every
        assert [r["count"] for r in fp32] == [2 * n_m]
        assert fp32[0]["fp32_backward_calls"] == n_m
        assert "held to the plain version on their own operands" in out
        assert "train trajectory on the fixed batch on the weights in fp32" \
            in out
        # the step-0 fp32 gradients on their own operands, every leaf
        assert "held leaf by leaf on their own operands" in out
        assert summary["block_grad_rel"] <= chip_smoke.STEP0_REL
        # the sLSTM recurrence timed in one step: each layer's pass and
        # recompute, and its backward
        n_s = cfg.n_layers // cfg.slstm_every
        assert len(summary["slstm_forward_ms"]) == 2 * n_s
        assert len(summary["slstm_backward_ms"]) == n_s
        assert 0 < summary["slstm_step_ms"] < summary["slstm_split_step_ms"]
        assert "the sLSTM recurrence (slstm.state) timed" in out
    else:
        assert not fp32
        assert "train trajectory on the fixed batch, routed" in out
    if make_batch == "frontend_batch":
        key = ("encoder_embeds" if cfg.is_encoder_decoder
               else "prefix_embeds")
        assert f"{key} (2, {cfg.n_prefix}, {cfg.d_model})" in out
        assert (cfg.n_prefix * 2, cfg.d_model, cfg.d_model) in table
    assert summary["model_tflop"] > 0 and summary["model_flops_share"] > 0
    assert "model FLOPs" in out
