"""K3's median / trimmed-mean route (``robust_kernel`` in
``src/repro_torch/kernels/delta_pipeline/csrc/delta_pipeline.cu``) emulated
on the CPU in torch float32.

The kernel sorts each column with Batcher's odd-even merge sort over
N2 = next power of two >= C entries (unselected clients are the
reference's +inf sentinels, padding rows sort after every value), then
selects with no dynamic index:

  * :func:`sort_keys` is the kernel's ``sort_key``: int32 keys in
    torch.sort's order of the floats, every NaN after +inf (and -0.0
    before +0.0); :func:`key_values` maps them back;
  * :func:`network` lists its compare-exchanges in the kernel's order,
    stage (P, K) by stage, each stage's pairs ascending, as ``merge_stage``
    unrolls them;
  * :func:`network_sort` applies them with ``torch.minimum`` /
    ``torch.maximum`` over rows of keys (a stage's pairs are disjoint, so
    one stage is one vectorised step);
  * :func:`robust_aggregate` is the kernel's selection: the median through
    a select chain over the constant indices, then ``0.5 * (lo + hi)``; the
    trimmed mean as a predicated sum over indices ascending from +0.0,
    divided by ``max(num_sel - 2 * k_trim, 1)``.
"""
from __future__ import annotations

import functools

import torch


def next_pow2(c: int) -> int:
    n2 = 1
    while n2 < c:
        n2 <<= 1
    return n2


@functools.cache
def network(n2: int) -> tuple[tuple[int, int, tuple[tuple[int, int], ...]], ...]:
    """The stages ``(P, K, pairs)`` of the kernel's network over ``n2``
    entries: P = 1, 2, ..., n2/2 and for each K = P, P/2, ..., 1; a pair
    ``(a, a + K)`` for every ``a`` the kernel's ``merge_stage`` condition
    admits (543 pairs in 21 stages at n2 = 64)."""
    stages = []
    p = 1
    while p < n2:
        k = p
        while k >= 1:
            j0 = k % p
            pairs = tuple(
                (a, a + k) for a in range(n2)
                if a >= j0 and ((a - j0) // k) % 2 == 0 and a + k < n2
                and a // (2 * p) == (a + k) // (2 * p)
            )
            stages.append((p, k, pairs))
            k //= 2
        p *= 2
    return tuple(stages)


def sort_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys whose order is torch.sort's (NaN last), as
    the kernel's ``sort_key``: every NaN one quiet NaN, then sign-magnitude
    bits to two's complement."""
    b = torch.where(torch.isnan(x), torch.tensor(0x7FFFFFFF, dtype=torch.int32),
                    x.to(torch.float32).view(torch.int32))
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def key_values(k: torch.Tensor) -> torch.Tensor:
    """The kernel's ``key_value``: int32 keys back to float32."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def network_sort_keys(v: torch.Tensor) -> torch.Tensor:
    """Sort the (N2, ...) int32 key rows of ``v`` ascending by the kernel's
    network (N2 a power of two); each compare-exchange puts
    ``torch.minimum`` in the lower row and ``torch.maximum`` in the upper."""
    v = v.clone()
    for _, _, pairs in network(v.shape[0]):
        lo = torch.tensor([a for a, _ in pairs], dtype=torch.long)
        hi = torch.tensor([b for _, b in pairs], dtype=torch.long)
        x, y = v[lo], v[hi]
        v[lo] = torch.minimum(x, y)
        v[hi] = torch.maximum(x, y)
    return v


def network_sort(v: torch.Tensor) -> torch.Tensor:
    """The float32 rows of ``v`` sorted as the kernel sorts them."""
    return key_values(network_sort_keys(sort_keys(v)))


def robust_aggregate(x: torch.Tensor, sel: torch.Tensor, num_sel: int, k_trim: int,
                     aggregator: str) -> torch.Tensor:
    """The kernel's median / trimmed mean of the (C, P) float32 values
    ``x`` over the rows ``sel`` (C,) bool, with the ``[num_sel, k_trim]``
    pair the wrapper hands it -> (P,) float32."""
    c = x.shape[0]
    n2 = next_pow2(c)
    inf_key = int(sort_keys(torch.tensor(float("inf"))))
    # Padding rows take the largest key (after NaN), unselected ones +inf.
    v = torch.full((n2,) + tuple(x.shape[1:]), 0x7FFFFFFF, dtype=torch.int32)
    v[:c] = torch.where(sel[:, None], sort_keys(x.to(torch.float32)), inf_key)
    v = network_sort_keys(v)
    if aggregator == "median":
        lo, hi = max((num_sel - 1) // 2, 0), num_sel // 2
        klo = khi = torch.full_like(v[0], inf_key)
        for i in range(n2):
            klo = v[i] if i == lo else klo
            khi = v[i] if i == hi else khi
        return torch.tensor(0.5, dtype=torch.float32) * (key_values(klo) + key_values(khi))
    total = torch.zeros(v.shape[1:], dtype=torch.float32)
    for i in range(n2):
        if k_trim <= i < num_sel - k_trim:
            total = total + key_values(v[i])
    return total / torch.tensor(float(max(num_sel - 2 * k_trim, 1)), dtype=torch.float32)
