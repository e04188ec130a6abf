"""The frozen arithmetic against hand-worked values."""
import pytest

from bench.harness import core, yardstick as y

NK = core.load_json("configs", "deepseek-v3-gemms")["gemms"]
# 2 M N K at M = 4096, and A + B + C bytes in e4m3, worked by hand
FLOPS_4096 = [124_017_180_672, 309_237_645_312, 137_438_953_472,
              962_072_674_304, 240_518_168_576, 120_259_084_288]
BYTES_4096_E4M3 = [53_149_696, 144_703_488, 153_092_096, 213_909_504,
                   75_497_472, 52_428_800]


def test_m4096_flops_bytes_and_bounds():
    r = y.gemm_round([4096], NK, "float8_e4m3fn")
    assert [g.flops for g in r] == FLOPS_4096
    assert [g.bytes for g in r] == BYTES_4096_E4M3
    assert sum(FLOPS_4096) == 1_893_543_706_624          # 1.894 TFLOP
    assert all(g.bound_by == "operations" for g in r)
    # e4m3 at 1,979 TFLOP/s: 956.8 us a round; bf16 at 989.4: 1.914 ms
    assert sum(g.least_s for g in r) == pytest.approx(956.8e-6, rel=1e-4)
    r16 = y.gemm_round([4096], NK, "bfloat16")
    assert sum(g.least_s for g in r16) == pytest.approx(1.9138e-3, rel=1e-4)
    assert r16[0].bytes == 2 * BYTES_4096_E4M3[0]


def test_flat_round_is_bound_by_bytes():
    r = y.gemm_round([64, 128], NK, "float8_e4m3fn")
    assert len(r) == 12
    assert sum(g.bytes for g in r) == 483_930_112                # 484 MB
    assert sum(g.k * g.n for g in r) == 462_290_944    # 462 MB of weights
    assert all(g.bound_by == "bytes" for g in r)
    assert sum(g.least_s for g in r) == pytest.approx(144.46e-6, rel=1e-4)


def test_train_flops_copy():
    c = core.load_json("configs", "deepseek-moe-16b")
    assert y.param_count(c) == 2_854_901_760
    assert y.active_params_excl_embed(c) == 638_212_096
    # 6 N D + 12 B S^2 H hd L at 5 layers, batch 4 x 1024: 16.2 TFLOP
    assert y.train_flops(c, 4, 1024) == 16_200_096_546_816


def test_train_gemms_of_a_step():
    c = core.load_json("configs", "deepseek-moe-16b")
    g = y.train_gemms(c, 4, 1024, c["loss_chunk"])
    # 1 dense layer (4 attention + 3 MLP), 4 MoE layers (4 attention,
    # router, 3 shared), 2 loss chunks of the head
    assert len(g) == 7 + 4 * 8 + 2
    assert g[-1] == y.Gemm(2048, 102400, 2048, "bfloat16", "bfloat16")
    assert sum(x.dtype == "float32" for x in g) == 4
    # dA = dC @ B^T is (4096, 2048, k 2048); dB = A^T @ dC (2048, 2048,
    # k 4096)
    assert y.backward_gemms(g[0]) == [
        y.Gemm(4096, 2048, 2048, "bfloat16", "bfloat16"),
        y.Gemm(2048, 2048, 4096, "bfloat16", "bfloat16")]
