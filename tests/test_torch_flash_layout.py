"""What the bf16 flash kernels compute on the host's terms, on the CPU: the
dropout mask of `csrc/flash_attention.cu`, held to `dropout_keep_mask` (the
TPU kernel's mask) bit for bit.

* The factored hash: fmix(row part ^ column part) with each part mixed
  once (the row's once per row, a key's once per key) and the last step
  folded into the compare, as the kernels compute it.
* The keep bits the forward writes in training: the layout
  (`dropout_keep_bits`, `keep_bits_words`) and the forward's assembly of a
  word from its threads' bits.

Ragged n (100, 256, 2048) and block_q 64 and 256. The kernels' own bits are
held to `dropout_keep_bits` on the card (tests/test_torch_flash_gpu.py).
"""

import numpy as np
import pytest
import torch

from manigaussian_tpu_torch.ops import flash_attention as F

CASES = [(100, 64), (100, 256), (256, 64), (256, 256), (2048, 64), (2048, 256)]
_M32 = 0xFFFFFFFF


@pytest.mark.parametrize("n,block_q", CASES)
def test_factored_hash_is_the_tpu_mask(n, block_q):
    bh, seed, rate = 2, 0x9E3779B9, 0.1
    rows = F.dropout_row_part(seed, bh, n, block_q)
    cols = F.dropout_col_part(n)
    keep = F.dropout_keep_from_parts(rows[:, :, None], cols[None, None, :], rate)
    assert torch.equal(keep, F.dropout_keep_mask(seed, rate, bh, n, block_q))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9, 2.0 ** -32, 1 - 2.0 ** -20])
def test_last_step_folds_into_the_compare(rate):
    """h ^ (h >> 16) >= T exactly when h ^ (T >> 16) >= T, for every h: the
    values whose high half ties T's, and random ones."""
    t = F.dropout_threshold(rate)
    rng = np.random.default_rng(3)
    h = np.concatenate([rng.integers(0, 2 ** 32, 200_000, dtype=np.int64),
                        (t >> 16 << 16) + np.arange(1 << 16, dtype=np.int64),
                        np.array([0, t, t - 1 if t else 0, _M32], np.int64)])
    assert np.array_equal((h ^ (h >> 16)) >= t, (h ^ (t >> 16)) >= t)


@pytest.mark.parametrize("n,block_q", CASES)
def test_keep_bits_layout(n, block_q):
    bh, seed, rate = 2, 77, 0.1
    bits = F.dropout_keep_bits(seed, rate, bh, n, block_q)
    mask = F.dropout_keep_mask(seed, rate, bh, n, block_q)
    words = F.keep_bits_words(n)
    assert bits.shape == (bh, n, words) and bits.dtype == torch.int32
    w = bits.numpy().astype(np.int64) & _M32
    m = mask.numpy()
    # bit c % 32 of word c // 32, read without the unpacking helper
    cols = np.arange(n)
    got = (w[:, :, cols // 32] >> (cols % 32)) & 1
    assert np.array_equal(got.astype(bool), m)
    # nothing set past key n
    pad = np.arange(words * 32) >= n
    full = (w[..., :, None] >> np.arange(32)) & 1
    assert not full.reshape(bh, n, -1)[..., pad].any()
    assert torch.equal(F.unpack_keep_bits(bits, n), mask)


def _forward_words(mask: np.ndarray, n: int) -> np.ndarray:
    """The forward's assembly of the keep bits: thread q of a quad builds,
    for its row and a 128-key tile, part w of each word: bit 8(j % 4) + e
    set where key 8j + 2q + e (j // 4 = w) is kept and lies below n, shifted
    by 2q; two exchanges leave thread q with the OR of the quad's parts of
    word q (traced here lane by lane)."""
    rows = mask.shape[0]
    words = F.keep_bits_words(n)
    out = np.zeros((rows, words), np.int64)
    for t in range(words // 4):
        x = np.zeros((4, 4, rows), np.int64)   # lane, word, row
        for q in range(4):
            for j in range(16):
                for e in range(2):
                    key = t * 128 + 8 * j + 2 * q + e
                    if key < n:
                        x[q, j // 4] |= mask[:, key].astype(np.int64) << (8 * (j % 4) + e)
            x[q] <<= 2 * q
        # each lane keeps one pair of words and sends the other (what its
        # partner, lane q ^ 2, keeps), then keeps one word of its pair and
        # sends the other to lane q ^ 1
        send = {q: (x[q, 0], x[q, 1]) if q & 2 else (x[q, 2], x[q, 3])
                for q in range(4)}
        a = {q: ((x[q, 2], x[q, 3]) if q & 2 else (x[q, 0], x[q, 1]))
             for q in range(4)}
        a = {q: (a[q][0] | send[q ^ 2][0], a[q][1] | send[q ^ 2][1])
             for q in range(4)}
        for q in range(4):
            odd = q & 1
            sent = a[q ^ 1][0] if (q ^ 1) & 1 else a[q ^ 1][1]
            out[:, 4 * t + q] = a[q][1 if odd else 0] | sent
    return out


@pytest.mark.parametrize("n,block_q", [(100, 64), (256, 256), (2048, 256)])
def test_forward_assembles_the_keep_bits_words(n, block_q):
    mask = F.dropout_keep_mask(5, 0.1, 1, n, block_q)[0].numpy()
    bits = F.dropout_keep_bits(5, 0.1, 1, n, block_q)[0].numpy().astype(np.int64) & _M32
    assert np.array_equal(_forward_words(mask, n), bits)


@pytest.mark.parametrize("n", [1, 32, 100, 128, 129, 256, 2048])
def test_keep_bits_words_cover_the_row_in_whole_tiles(n):
    words = F.keep_bits_words(n)
    assert words % 4 == 0 and words * 32 >= n and (words - 4) * 32 < n
