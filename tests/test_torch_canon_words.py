"""The canonical stream's packed word [r2 | flags:4 | offset:off_bits] at
300 bp reads and -l 40: canon_off_bits gives 9 offset bits, which leaves
19 bits of read id, so the one-word layout (and the hybrid engine) takes
at most 2^19 - 1 unique reads; the widest offset and read id round-trip
through the device pipeline's and the hybrid's unpacking."""

import types

import numpy as np
import pytest
import torch

from metagenomics_tpu.ops.device_overlap import canon_off_bits as jax_bits
from metagenomics_tpu_torch.ops.device_overlap import (MASK32,
                                                       DeviceOverlapPipeline,
                                                       canon_off_bits)

R2_MAX = (1 << 19) - 1


@pytest.mark.parametrize("n_unique,lmax,bits", [
    (1024, 300, 9), (74_475, 300, 9), (R2_MAX, 300, 9), (R2_MAX + 1, 300, -1),
    (2_097_151, 300, -1), (10_000_000, 300, -1),
    # 150 bp keeps its limit: 7 offset bits, 21 of read id
    (2_097_151, 150, 7), (2_097_152, 150, -1)])
def test_canon_off_bits(n_unique, lmax, bits):
    assert canon_off_bits(n_unique, lmax, 40) == bits
    assert jax_bits(n_unique, lmax, 40) == bits


@pytest.mark.parametrize("r2,fe,off", [
    (R2_MAX, 4 | 3, 260), (R2_MAX, 8 | 1, 260), (1, 4, 0), (R2_MAX, 8, 1),
    (12345, 4 | 2, 137)])
def test_word_round_trips_at_9_bits(r2, fe, off):
    """The word _emit2 packs (its expression, on int64 tensors) reads back
    as the same r2, flags and offset through _unpack_words (the device
    engine's stream) and the hybrid's host decoding (graph/build.py)."""
    ob = canon_off_bits(R2_MAX, 300, 40)
    t = lambda x: torch.tensor([x], dtype=torch.int64)  # noqa: E731
    word = ((t(r2) << (4 + ob)) | (t(fe) << ob)
            | torch.clamp(t(off), 0, (1 << ob) - 1)) & MASK32
    words = word.numpy().astype(np.uint32)
    assert int(words[0]) == int(word[0]) < 1 << 32
    got_r2, meta = DeviceOverlapPipeline._unpack_words(
        types.SimpleNamespace(off_bits=ob), words)
    assert int(got_r2[0]) == r2
    assert int(meta[0]) & 15 == fe and int(meta[0]) >> 4 == off
    assert int(words[0] >> np.uint32(4 + ob)) == r2
    assert int((words[0] >> np.uint32(ob)) & np.uint32(15)) == fe
    assert int(words[0] & np.uint32((1 << ob) - 1)) == off
