"""The port's tensor-parallel LM round (``make_round_fn(rules=...)`` on a
plan with a model split) on 4 CPU ranks (``dist.world``, gloo), reduced
llama3.2-1b in float32, against the single-device JAX round and the
port's single-process round.

No JAX test executes a tensor axis (scaled plans set the model split to
1; only the 256-device dry run lowers the production plans), and the
JAX package's sharded round fails its selftests on this tree (ROADMAP
R3), so the reference is its single-device round, as for the
client-sharded round: ``_lm_parity``'s configuration (16 clients, 4
slots, 2 local steps), two rounds from the JAX initial state, the
ranks replaying the single-process round's draws. The plans are
``MeshPlan`` s built directly, (client, zero, tp, sp): (2, 1, 2, 1) with
gates plain (FedAvg), legacy (FedAvgM) and full (clip, DP, int8), each
with and without ``use_pallas_agg``; then (1, 1, 2, 2), (1, 1, 4, 1)
(the reduced config's 2 kv heads replicated over tp 4) and
(1, 2, 2, 1). Held (``_tp_round.hold_tp``): rank 0's gathered state and
metrics against JAX (``MODEL_TOL``; int8: ``INT8_TOL``) and the
single-process round, every rank's gathered state equal, the ledger's
contract, and each rank's block shapes. Then a sharded state's
checkpoint, saved whole, read by the JAX package's loader and restored
into each rank's blocks.
"""
import dataclasses

import jax
import numpy as np
import pytest
from _dist_cases import Recording  # noqa: F401 (the ranks import it by name)
from _lm_parity import MODEL_TOL, configs, one_thread  # noqa: F401 (autouse)
from _sharded_round import INT8_TOL
from _tp_cases import rank_checkpoint
from _tp_round import (  # noqa: F401 (fixtures)
    GATES,
    hold_blocks,
    hold_tp,
    jax_round,
    run_tp_case,
    world,
)

from repro.checkpoint import restore as jax_restore
from repro.configs import get_reduced as jax_reduced
from repro.fl import init_fl_state as jax_init
from repro.models import build_model as jax_build
from repro_torch import convert, tree
from repro_torch.configs import get_reduced

ARCH = "llama3.2-1b"


@pytest.mark.parametrize("pallas", [False, True], ids=["plain-path", "kernel-path"])
@pytest.mark.parametrize("gates", list(GATES))
def test_tp_round_matches_jax(world, gates, pallas):
    split = (2, 1, 2, 1)
    out = run_tp_case(world, ARCH, gates, pallas, split)
    hold_tp(*out, INT8_TOL if gates == "full" else MODEL_TOL, split)
    hold_blocks(ARCH, out[-1], split)


@pytest.mark.parametrize("split", [(1, 1, 2, 2), (1, 1, 4, 1), (1, 2, 2, 1)],
                         ids=["tp2-sp2", "tp4-kv-replicated", "zero2-tp2"])
def test_tp_round_splits_match_jax(world, split):
    out = run_tp_case(world, ARCH, "legacy", True, split)
    hold_tp(*out, MODEL_TOL, split)
    hold_blocks(ARCH, out[-1], split)


def test_sharded_checkpoint_is_whole_and_read_by_jax(world, tmp_path):
    """A (tp 2, sp 2) state saved whole from its blocks: the JAX loader
    restores the JAX state's own parameters and momentum, and every rank
    restores its blocks bit for bit."""
    jm = jax_build(jax_reduced(ARCH, param_dtype="float32", compute_dtype="float32"))
    jfl, _ = configs(GATES["legacy"])
    js = jax.tree.map(np.asarray, jax_init(jm, jfl, jax.random.PRNGKey(0)))
    js = dataclasses.replace(
        js, server_mu=jax.tree.map(lambda p: (0.5 * p).astype(np.float32), js.params),
        step=np.int32(3))
    cfg = get_reduced(ARCH, param_dtype="float32", compute_dtype="float32")
    ts = convert.fl_state_from_jax(cfg, js, device="cpu")
    ranks = world.run(rank_checkpoint, dict(arch=ARCH, split=(1, 1, 2, 2), state=ts,
                                            dir=str(tmp_path)))
    assert all(r["same"] for r in ranks)
    assert {r["shapes"][0] for r in ranks} == {(cfg.padded_vocab // 4, cfg.d_model)}
    back = jax_restore(str(tmp_path), 3, jax_init(jm, jfl, jax.random.PRNGKey(1)))
    for a, b in zip(jax.tree.leaves([js.params, js.server_mu]),
                    jax.tree.leaves([back.params, back.server_mu])):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert int(back.step) == int(js.step)
    np.testing.assert_array_equal(np.asarray(back.rng), np.asarray(js.rng))
    assert [x.shape for x in tree.leaves(ts.params)] == [
        np.shape(x) for x in jax.tree.leaves(back.params)]
