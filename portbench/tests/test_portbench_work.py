"""The frozen work counts against shapes worked by hand."""
from __future__ import annotations

import pytest

from portbench.frozen import peaks
from portbench.frozen import work as fw


def test_mask_pairs_causal_and_window():
    assert fw.mask_pairs(4, 4, causal=True) == 10
    assert fw.mask_pairs(4, 4, causal=False) == 16
    assert fw.mask_pairs(2, 4, causal=True) == 3 + 4
    assert fw.mask_pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2


def test_flash_work_by_hand():
    # B=2, S=3 causal: 6 pairs; 4*D FLOPs a pair and query head
    w = fw.flash_work(2, 3, 3, 4, 2, 8, causal=True)
    assert w.flops == 4 * 8 * 6 * 2 * 4
    # q and o (2*3*4*8 each), k and v (2*3*2*8 each), 2 bytes each
    assert w.bytes == 2 * (2 * 192 + 2 * 96)
    assert w.peak == peaks.BF16_FLOPS


def test_flash_work_of_the_chat_prefill():
    w = fw.flash_work(32, 512, 512, 32, 8, 128, causal=True)
    assert w.flops == 4 * 128 * (512 * 513 // 2) * 32 * 32
    assert w.bound_s() == pytest.approx(w.bytes / peaks.HBM_BYTES_PER_S)


def test_sspnna_conv_work_by_hand():
    w = fw.sspnna_conv_work(pairs=10, rows_in=4, rows_out=4, c=2, n=3)
    assert w.flops == 2 * 10 * 2 * 3
    assert w.bytes == 4 * (4 * 2 + 27 * 2 * 3 + 10 + 4 * 3)
    assert w.peak == peaks.F32_3XTF32_FLOPS == pytest.approx(165e12)
    assert (w + w).flops == 2 * w.flops


def test_work_at_two_peaks_does_not_add():
    with pytest.raises(ValueError):
        fw.sspnna_conv_work(1, 1, 1, 1, 1) + fw.flash_work(
            1, 1, 1, 1, 1, 1, causal=True)


def test_granite_matmul_params():
    n = fw.decoder_matmul_params(36, 4096, 32, 8, 128, 14336, 49152)
    per_layer = 4096 * 128 * (64 + 16) + 3 * 4096 * 14336
    assert n == 36 * per_layer + 4096 * 49152
    assert 8.0e9 < n < 8.1e9


def test_decoder_request_flops_by_hand():
    # 3 prompt tokens, 2 generated: 4 tokens through the model, 10 pairs
    assert fw.decoder_request_flops(100, 2, 4, 8, 3, 2) == (
        2 * 100 * 4 + 4 * 2 * 4 * 8 * 10)
