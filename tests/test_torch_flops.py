"""The port's `launch/flops.py` against the JAX reference's.

Pure arithmetic over a config, so every count must equal the reference's
exactly: `model_flops` (each of its four terms) for every full and smoke
configuration of the registry, for train, prefill and decode at several
(batch, seq), one of them shorter than the SSM chunk; and its parts,
`active_params_excl_embed` and `slstm_recurrent_flops`. The port's module
reads the port's `ssm.CHUNK`, which must equal the reference's. Each
package's parameter count (a shape trace of the whole model) is taken once
per configuration and kept for the other sizes and kinds.
"""
import functools

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import flops as tflops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCHS = jconfigs.list_archs()
KINDS = ["train", "prefill", "decode"]
SIZES = [(1, 64), (2, 1024), (4, 4096), (8, 96)]


def _cfgs(arch, smoke):
    get = "smoke_config" if smoke else "get_config"
    return getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)


def test_registry_and_chunk_match_the_reference():
    assert tconfigs.list_archs() == ARCHS and len(ARCHS) == 10
    assert tssm.CHUNK == jssm.CHUNK


@pytest.fixture
def counted_once(monkeypatch):
    """Both packages' `active_params_excl_embed`, each config's count kept
    after its first call (the counts are held apart in
    test_parts_equal_reference)."""
    for mod in (jflops, tflops):
        monkeypatch.setattr(mod, "active_params_excl_embed",
                            _COUNTS[mod.__name__])


_COUNTS = {mod.__name__: functools.lru_cache(maxsize=None)(
    mod.active_params_excl_embed) for mod in (jflops, tflops)}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equals_reference(arch, kind, smoke, counted_once):
    jcfg, tcfg = _cfgs(arch, smoke)
    for b, s in SIZES:
        got = tflops.model_flops(tcfg, b, s, kind)
        want = jflops.model_flops(jcfg, b, s, kind)
        assert got == want, (b, s)
        assert set(got) == {"matmul", "attention", "slstm_correction",
                            "total"}
        assert all(isinstance(v, float) for v in got.values())
        assert got["total"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_parts_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch, smoke=False)
    n = tflops.active_params_excl_embed(tcfg)
    assert n == jflops.active_params_excl_embed(jcfg) > 0
    for kind in KINDS:
        for b, s in SIZES:
            got = tflops.slstm_recurrent_flops(tcfg, b, s, kind)
            assert got == jflops.slstm_recurrent_flops(jcfg, b, s, kind)
            assert (got > 0) == (arch == "xlstm-1.3b")
    # the train count is the 6ND convention over the active parameters
    # plus the attention and sLSTM terms
    m = tflops.model_flops(tcfg, 2, 1024, "train")
    assert m["matmul"] == 6.0 * n * 2 * 1024
    assert m["total"] == m["matmul"] + m["attention"] + m["slstm_correction"]
