"""Each work count against one shape computed by hand: each input read
once, each output written once."""

import pytest

from gpubench import cells

DCNN = cells.config("dcnn-wpt-sym5-l8")
AST = cells.config("ast-base384-stft")


def test_wpt_level8_sym5_one_frame():
    flops, nbytes = cells.work_module("wpt").flops_bytes(1, 22050, 10, 8)
    # lengths 22050 -> 11029 -> 5519 -> 2764 -> 1386 -> 697 -> 353 -> 181 -> 95;
    # level l writes 2^l nodes, 2 x 10 flops an output
    assert flops == 20 * (2 * 11029 + 4 * 5519 + 8 * 2764 + 16 * 1386 + 32 * 697
                          + 64 * 353 + 128 * 181 + 256 * 95)
    assert nbytes == 4 * (22050 + 256 * 95)


def test_fused_conv1_one_window():
    fb = cells.work_module("fused_conv1").flops_bytes(1, 2, 2, 1)
    # out 2x2 (pad, pool), params 11 floats, x 4 floats, out 4 floats + 4 codes, 2 moments
    assert fb["fwd"] == (4 * 72, 16 + 44 + 20 + 8)
    assert fb["bwd"] == (4 * 20, 16 + 44 + 20 + 8 + 44)


def test_fused_pool_one_window():
    fb = cells.work_module("fused_pool").flops_bytes(1, 1, 2, 2)
    assert fb["fwd"] == (8, 16 + 5 + 8)
    assert fb["bwd"] == (8, 9 + 16)


def test_fused_conv2_one_window():
    fb = cells.work_module("fused_conv2").flops_bytes(1, 1, 1, 2, 2)
    small = 4 * (9 + 4)
    assert fb["fwd"] == (4 * 18, 16 + small + 5)
    assert fb["bwd"] == (2 * 18, 32 + 9 + 2 * small)


def test_flash_mha_two_tokens_one_head():
    fb = cells.work_module("flash_mha").flops_bytes(1, 2, 1, 64)
    product = 2 * 2 * 2 * 64
    qkv, out, st = 4 * 2 * 3 * 64, 4 * 2 * 64, 4 * 2 * 2
    assert fb["fwd"] == (2 * product, qkv + out + st)
    assert fb["bwd"] == (5 * product, 2 * qkv + out + st)


def test_shapes_from_the_configurations():
    assert cells.work_module("fused_conv1").work(DCNN, 128)["fused_conv1_cuda.FWD_LAUNCHES"] \
        == cells.work_module("fused_conv1").flops_bytes(128, 95, 256, 64)["fwd"]
    assert cells.work_module("fused_pool").work(DCNN, 128)["fused_pool_cuda.POOL_BWD_LAUNCHES"] \
        == cells.work_module("fused_pool").flops_bytes(128, 64, 24, 64)["bwd"]
    assert cells.work_module("fused_conv2").work(DCNN, 128)[
        "fused_conv2_cuda.CONV2_FWD_LAUNCHES"] \
        == cells.work_module("fused_conv2").flops_bytes(128, 64, 96, 48, 129)["fwd"]
    assert cells.work_module("flash_mha").tokens(AST) == 25 * 9 + 2
    assert cells.work_module("wpt").work(DCNN, 128)["wpt_cuda.LAUNCHES"] \
        == cells.work_module("wpt").flops_bytes(128, 22050, 10, 8)


def test_dcnn_model_flops():
    layers = cells.work_module("dcnn-wpt-sym5-l8").layers(DCNN)
    fwd = [f for f, _ in layers]
    assert fwd[:6] == [2 * 9 * 64 * 97 * 258, 2 * 64 * 64 * 48 * 129, 2 * 9 * 64 * 96 * 48 * 129,
                       2 * 9 * 96 * 128 * 24 * 64, 2 * 9 * 128 * 32 * 24 * 64,
                       2 * 9 * 32 * 64 * 24 * 64]
    # the dilated block: (64, 32) -> (64, 32) -> (60, 28) -> (40, 8), 12 channels
    assert fwd[6:9] == [2 * 9 * 144 * 64 * 32, 2 * 25 * 144 * 60 * 28, 2 * 49 * 144 * 40 * 8]
    assert fwd[9] == 2 * 320 * 2 * 12
    total = cells.work_module("dcnn-wpt-sym5-l8").model_flops(DCNN, 128)
    wpt, _ = cells.work_module("wpt").flops_bytes(1, 22050, 10, 8)
    assert total == 128 * (3 * sum(fwd) - fwd[0] + wpt)
    assert 480e9 < total < 500e9


def test_ast_model_flops():
    n, d = 227, 768
    block = 2 * n * d * (4 * d + 2 * 3072) + 4 * n * n * d
    embed = 2 * 256 * d * 225
    fwd = embed + 12 * block + 2 * d * 2
    assert cells.work_module("ast-base384-stft").model_flops(AST, 32) == 32 * (3 * fwd - embed)
    assert fwd / n == pytest.approx(178.6e6, rel=0.01)
