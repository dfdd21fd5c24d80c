"""Cases and numpy-seeded inputs of the attention kernels' tests (K5 and
K7), shared by the CPU parity tests and the card tests. Imports no JAX,
so the card tests run where only PyTorch is installed."""
import numpy as np

# K5: (B, H, Hkv, Sq, Sk, hd, window (kernel convention, 0 = global),
# bidirectional)
FLASH_CASES = [
    (1, 4, 2, 16, 16, 16, 0, False),  # causal, GQA 2
    (2, 4, 1, 16, 16, 16, 0, False),  # GQA 4
    (1, 4, 4, 16, 16, 32, 0, False),  # no GQA
    (1, 4, 2, 16, 16, 16, 5, False),  # sliding window
    (1, 4, 2, 16, 16, 16, 0, True),  # bidirectional
    (1, 4, 2, 8, 24, 16, 0, False),  # Sq < Sk, tail-aligned
    (1, 4, 2, 8, 24, 16, 6, False),  # Sq < Sk with a window
]

# K7: (slots, hkv, group, hd, page, pages_per_slot, window (model
# convention, -1 = global)), the JAX package's serving-test cases
PAGED_CASES = [
    (4, 2, 1, 64, 8, 3, -1),
    (4, 2, 4, 64, 8, 3, -1),  # GQA
    (3, 1, 2, 128, 16, 2, -1),  # wide head
    (4, 2, 2, 64, 8, 4, 12),  # sliding window
    (5, 2, 2, 64, 4, 5, 6),  # window < page span
]


def flash_inputs(b, h, hkv, sq, sk, hd, seed=0):
    """float32 q (B, H, Sq, hd), k and v (B, Hkv, Sk, hd)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd)))


def paged_inputs(s, hkv, g, hd, page, n, seed=0):
    """Pools with every physical page filled (trash page 0 included), a
    table of shuffled pages whose entries past each slot's live pages are
    0, ragged lengths from 1 to the full span, and one empty slot."""
    rng = np.random.default_rng(seed)
    num_pages = s * n + 1
    q = rng.standard_normal((s, hkv * g, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, page, hkv, hd)).astype(np.float32)
              for _ in range(2))
    lengths = np.linspace(1, n * page, s).round().astype(np.int32)
    lengths[s // 2] = 0
    perm = rng.permutation(num_pages - 1) + 1
    table = np.zeros((s, n), np.int32)
    for i, ln in enumerate(lengths):
        live = -(-int(ln) // page)
        table[i, :live] = perm[i * n:i * n + live]
    return q, kp, vp, table, lengths
