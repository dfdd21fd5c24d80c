"""Adversarial client behaviours, paper §IV.D (port of
``repro/fl/attacks.py``).

Four attacks, matching Table V:
  * label_flip        — class k -> (K-1)-k on the malicious clients' labels;
  * noise             — Gaussian perturbation of the client's delta;
  * dropout           — the client drops (delta zeroed and excluded);
  * model_replacement — the client returns an arbitrary large update.

All act on client-stacked trees with a (C,) malicious mask. The noise of
``noise`` and ``model_replacement`` comes from the draw provider: one
(C, P) block of standard normals per call, leaf by leaf in
``tree.leaves`` order (``segments=``), as the JAX package draws one key
per leaf.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree


def flip_labels(tokens: torch.Tensor, malicious: torch.Tensor, vocab_size: int):
    """tokens: (C, ...) int; malicious: (C,) bool. k -> (V-1)-k."""
    m = malicious.reshape((-1,) + (1,) * (tokens.dim() - 1))
    return torch.where(m, (vocab_size - 1) - tokens, tokens)


def corrupt_deltas(
    deltas, malicious: torch.Tensor, kind: str, draws, *, round: int,
    site: str = "attack", noise_scale: float = 0.5, replacement_scale: float = 10.0,
    rows: slice | None = None,
):
    """Apply a delta-space attack to the malicious rows of ``deltas``, a
    (C, ...) tree. ``draws`` and ``site`` name the normals' source, keyed
    by ``round``. ``rows`` says which of the (C,) ``malicious`` rows
    ``deltas`` holds (a rank's slots under mesh rules): the normals are
    drawn for all C rows, as on one device, and sliced."""
    if kind in ("none", "label_flip"):
        return deltas  # label_flip acts on data, not deltas
    flat = tree.leaves(deltas)
    n = malicious.shape[0]
    if rows is not None:
        malicious = malicious[rows]

    def mal(x):
        return malicious.reshape((-1,) + (1,) * (x.dim() - 1))

    if kind == "dropout":
        return tree.unflatten(
            deltas, [torch.where(mal(x), torch.zeros_like(x), x) for x in flat])
    if kind not in ("noise", "model_replacement"):
        raise ValueError(f"unknown attack {kind!r}")
    sizes = tuple(math.prod(x.shape[1:]) for x in flat)
    z = draws.normal(site, (n, sum(sizes)), segments=sizes, round=round)
    if rows is not None:
        z = z[rows]
    out = []
    for x, zi in zip(flat, torch.split(z, sizes, dim=1)):
        zi = zi.reshape(x.shape).to(x.dtype)
        if kind == "noise":
            out.append(torch.where(mal(x), x + noise_scale * zi, x))
        else:
            out.append(torch.where(mal(x), replacement_scale * zi, x))
    return tree.unflatten(deltas, out)


def dropout_mask(mask: torch.Tensor, malicious: torch.Tensor, kind: str):
    """Dropout also removes the client from the aggregation weights."""
    if kind == "dropout":
        return mask & ~malicious
    return mask
