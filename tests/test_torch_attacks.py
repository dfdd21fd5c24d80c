"""The port's attacks (``repro_torch.fl.attacks``) against the JAX package.

Inputs are made from a seed with numpy. The port takes its normals from
``_jax_draws.JaxDraws`` (the ``attack`` site is the round key's attack
split, ``faults.noise`` the fault sub-key's noise half), and the JAX
functions get the same keys, so the corrupted deltas agree to one
float32 rounding of ``x + s·z`` (``rtol=1e-6``), masks and labels
exactly.
"""
import jax
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)

from repro.fl import attacks as ja
from repro_torch import tree
from repro_torch.fl import attacks as ta
from repro_torch.random import TorchDraws

C = 6
SEED = 5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _deltas(seed=0):
    """A (C, ...) two-layer MLP delta tree, as numpy."""
    rng = np.random.default_rng(seed)
    return [
        {"w": rng.normal(0, 0.05, (C, 7, 5)).astype(np.float32),
         "b": rng.normal(0, 0.05, (C, 5)).astype(np.float32)},
        {"w": rng.normal(0, 0.05, (C, 5, 3)).astype(np.float32),
         "b": rng.normal(0, 0.05, (C, 3)).astype(np.float32)},
    ]


def _torch_tree(t):
    return tree.map(torch.from_numpy, t)


def _malicious(seed=1):
    return np.random.default_rng(seed).random(C) < 0.5


@pytest.mark.parametrize("shape,vocab", [((C,), 62), ((C, 96), 6), ((C, 4, 9), 128)])
def test_flip_labels_matches_jax(shape, vocab):
    rng = np.random.default_rng(2)
    tok = rng.integers(0, vocab, shape).astype(np.int32)
    mal = _malicious()
    want = ja.flip_labels(tok, mal, vocab)
    got = ta.flip_labels(torch.from_numpy(tok).long(), torch.from_numpy(mal), vocab)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["none", "label_flip", "noise", "model_replacement",
                                  "dropout"])
def test_dropout_mask_matches_jax(kind):
    mask = np.random.default_rng(3).random(C) < 0.7
    mal = _malicious()
    got = ta.dropout_mask(torch.from_numpy(mask), torch.from_numpy(mal), kind)
    np.testing.assert_array_equal(_np(got), np.asarray(ja.dropout_mask(mask, mal, kind)))


@pytest.mark.parametrize("kind", ["none", "label_flip", "noise", "model_replacement",
                                  "dropout"])
def test_corrupt_deltas_matches_jax(kind):
    """Each kind on the ``attack`` site of round 2, the malicious rows
    masked by participation as the simulator passes them."""
    d, mal = _deltas(), _malicious()
    draws = JaxDraws(SEED)
    key = draws.round_key(2, "attack")
    want = ja.corrupt_deltas(d, mal, kind, key, noise_scale=0.3, replacement_scale=2.0)
    got = ta.corrupt_deltas(_torch_tree(d), torch.from_numpy(mal), kind, draws, round=2,
                            noise_scale=0.3, replacement_scale=2.0)
    for lw, lt in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_allclose(_np(lt), np.asarray(lw), rtol=1e-6, atol=1e-8)
    if kind in ("none", "label_flip"):
        for a, b in zip(tree.leaves(got), jax.tree.leaves(d)):
            np.testing.assert_array_equal(_np(a), b)


def test_corrupt_deltas_fault_noise_site_matches_jax():
    """The corrupted payloads of the fault layer: the noise attack on the
    ``faults.noise`` site, which is the JAX package's
    ``split(fold_in(k, 8))[1]``."""
    d, mal = _deltas(4), _malicious(5)
    draws = JaxDraws(SEED)
    key = draws.round_key(1, "faults.noise")
    want = ja.corrupt_deltas(d, mal, "noise", key, noise_scale=0.05)
    got = ta.corrupt_deltas(_torch_tree(d), torch.from_numpy(mal), "noise", draws,
                            round=1, site="faults.noise", noise_scale=0.05)
    for lw, lt in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_allclose(_np(lt), np.asarray(lw), rtol=1e-6, atol=1e-8)


def test_unknown_attack_raises():
    d = _torch_tree(_deltas())
    mal = torch.from_numpy(_malicious())
    with pytest.raises(ValueError, match="unknown attack"):
        ta.corrupt_deltas(d, mal, "sybil", TorchDraws(0, "cpu"), round=0)


@pytest.mark.parametrize("kind", ["noise", "model_replacement", "dropout"])
def test_production_attack_touches_only_malicious_rows(kind):
    """With the production provider: honest rows pass bit for bit, the
    malicious rows change, and the draw replays from its key."""
    d = _torch_tree(_deltas(6))
    mal = torch.from_numpy(_malicious(7))
    assert mal.any() and (~mal).any()
    a = ta.corrupt_deltas(d, mal, kind, TorchDraws(3, "cpu"), round=4)
    b = ta.corrupt_deltas(d, mal, kind, TorchDraws(3, "cpu"), round=4)
    for x, y, z in zip(tree.leaves(a), tree.leaves(b), tree.leaves(d)):
        assert torch.equal(x, y)
        assert torch.equal(x[~mal], z[~mal])
        assert not torch.equal(x[mal], z[mal])
        assert torch.isfinite(x).all()
