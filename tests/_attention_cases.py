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

# K7 at the boundaries of its split plan (``split_plan``: 10 pages -> 5
# blocks of 2, 40 pages -> 8 blocks of 5 through a ring of 4 pages):
# (slots, hkv, group, hd, page, pages_per_slot, window (model
# convention), lengths)
PAGED_SPLIT_CASES = [
    # empty, one live token, fewer live pages than splits, a split's edge
    # (8 = two pages), across it (9), the full n_pages·page
    (8, 2, 4, 64, 4, 10, -1, [0, 1, 5, 8, 9, 40, 17, 24]),
    # a window that kills whole splits (length 40: pages 8 and 9 live)
    (5, 2, 4, 64, 4, 10, 6, [40, 33, 21, 0, 3]),
    # more pages per split than the ring holds
    (5, 2, 2, 64, 4, 40, -1, [160, 77, 1, 0, 120]),
    (5, 2, 2, 64, 4, 40, 50, [160, 77, 1, 0, 120]),
    (2, 1, 8, 128, 8, 3, -1, [24, 10]),  # g 8, hd 128, splits of one page
]


def flash_inputs(b, h, hkv, sq, sk, hd, seed=0):
    """float32 q (B, H, Sq, hd), k and v (B, Hkv, Sk, hd)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd)))


def paged_inputs(s, hkv, g, hd, page, n, seed=0, lengths=None):
    """Pools with every physical page filled (trash page 0 included), a
    table of shuffled pages whose entries past each slot's live pages are
    0, and ``lengths`` or else ragged lengths from 1 to the full span with
    one empty slot."""
    rng = np.random.default_rng(seed)
    num_pages = s * n + 1
    q = rng.standard_normal((s, hkv * g, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, page, hkv, hd)).astype(np.float32)
              for _ in range(2))
    if lengths is None:
        lengths = np.linspace(1, n * page, s).round().astype(np.int32)
        lengths[s // 2] = 0
    lengths = np.asarray(lengths, np.int32)
    perm = rng.permutation(num_pages - 1) + 1
    table = np.zeros((s, n), np.int32)
    for i, ln in enumerate(lengths):
        live = -(-int(ln) // page)
        table[i, :live] = perm[i * n:i * n + live]
    return q, kp, vp, table, lengths
