"""The frozen arithmetic against numbers worked out by hand for the
three cells."""
import pytest

from portbench import flops, spec

SC = spec.find_config("starcoder2-3b-15L")
MX = spec.find_config("mixtral-8x7b-16L")

# starcoder2-3b at 15 layers: one tied table 49,152 x 3,072 (the
# embedding and the head);
# a layer: q and o 2 x 3,072 x 3,072, k and v 2 x 3,072 x 256, biases
# 3,072 + 512, MLP 2 x 3,072 x 12,288, two norms 2 x 3,072
SC_LAYER = 2 * 3072 * 3072 + 2 * 3072 * 256 + 3584 + 2 * 3072 * 12288 \
    + 6144
SC_N = 49152 * 3072 + 15 * SC_LAYER
# mixtral-8x7b at 16 layers: q and o 2 x 4,096 x 4,096, k and v
# 2 x 4,096 x 1,024, 8 experts of 3 x 4,096 x 14,336, router 4,096 x 8
MX_LAYER = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 8 * 3 * 4096 * 14336 \
    + 4096 * 8 + 8192
MX_N = 2 * 32000 * 4096 + 16 * MX_LAYER


def test_param_counts():
    assert SC_N == 1_590_311_424
    assert flops.param_count(SC) == SC_N
    assert MX_N == 23_482_466_304
    assert flops.param_count(MX) == MX_N
    assert flops.active_param_count(MX) == MX_N - 16 * 6 * 3 * 4096 * 14336
    assert flops.active_param_count(MX) == 6_571_032_576


def test_train_step_flops():
    matmul = SC_N          # the lookup does none; the tied head does
    per_token = 2 * matmul + 4 * 24 * 128 * 512 * 15   # mean span 512
    want = 3 * per_token * 8 * 1024
    assert want == 80_486_269_452_288
    assert flops.train_step_flops(SC, 8, 1024) == pytest.approx(want,
                                                                rel=1e-12)


def test_prefill_and_decode_flops():
    matmul = SC_N
    want = (2 * matmul + 4 * 24 * 128 * 1024 * 15) * 2048
    assert flops.prefill_flops(SC, 2048) == pytest.approx(want, rel=1e-12)
    assert flops.decode_flops(SC, 2047) == pytest.approx(
        2 * matmul + 4 * 24 * 128 * 2048 * 15, rel=1e-12)
    mx_matmul = 6_571_032_576 - 32000 * 4096
    assert flops.request_flops(MX, 1000, 3) == pytest.approx(
        (2 * mx_matmul + 4 * 32 * 128 * 500 * 16) * 1000
        + 2 * (2 * mx_matmul) + 4 * 32 * 128 * 16 * (1001 + 1002),
        rel=1e-12)


def test_ring_pack_bytes():
    # compress none: the f32 gradient read once, the f32 wire written once
    assert flops.ring_pack_bytes(SC_N, "none") == 12_722_491_392
    # bf16 with error feedback: gradient and residual read, bf16 wire and
    # residual written; the unpack reads bf16 and writes f32
    assert flops.ring_pack_bytes(10, "bf16") == 10 * (4 + 4 + 2 + 4 + 2 + 4)
    with pytest.raises(ValueError):
        flops.ring_pack_bytes(10, "int8_ef")
