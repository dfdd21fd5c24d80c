"""The gate of ``repro_torch.dist.selftest``: rank 0 of the sharded round
held against the single-process round (``reference_rounds``, ``_hold``,
``element_bound``, ``fingerprint``), and the card default of the three
distributed entry points.

A 2-rank CPU world (plan client 2 × zero 1, as the smoke's ``dist``
phase runs on the card) trains reduced llama3.2-1b in float32 for two
rounds (legacy, then full); its rank 0 fingerprints pass the gate as
they are, and fail it once a parameter is off by twice its bound, the
server momentum is scaled by 1 + 1e-5, or a leaf's sum is off. The bf16
bound is held on a bf16 leaf: one ulp passes, two fail.
"""
import copy

import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch import tree
from repro_torch.dist import selftest as st
from repro_torch.dist.meshes import plan_for
from repro_torch.dist.world import World, spawn
from repro_torch.kernels.delta_pipeline import fog_selftest, sharded_selftest
from repro_torch.models import build_model

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """(spec, rank 0's records) of two sharded rounds on two CPU ranks."""
    spec = dict(arch="llama3.2-1b", scale="tiny", devices=2, zero=1, fog_nodes=1,
                population=None, gates=["legacy", "full"], pallas_agg=True, seq_len=16,
                local_steps=1, seed=0, state_dir=str(tmp_path_factory.mktemp("states")))
    per_rank = spawn(st.rank_rounds, 2, spec, device="cpu", timeout=300.0)
    assert all(rec["contract_error"] is None for r in per_rank for rec in r)
    return spec, per_rank[0]


def _check(rounds, edit=None):
    spec, rank0 = rounds
    rank0 = copy.deepcopy(rank0)
    if edit is not None:
        edit(rank0)
    return st.reference_rounds(spec, rank0, CPU)


def test_rank0_holds_against_the_single_process_round(rounds):
    held = _check(rounds)
    assert [h["gates"] for h in held] == ["legacy", "full"]
    for h in held:
        assert h["ok"], h
        assert h["params"]["worst_share_of_tol"] <= 1.0
        assert "server_mu" in h  # FedAvgM: the momentum is held too


def _bump_param(rank0):
    fp = rank0[1]["params"][0]
    fp["vals"][0] += 2 * st.F32_PARAM_TOL


def _scale_mu(rank0):
    s = 1.0 + 1e-5
    for fp in rank0[0]["server_mu"]:
        fp["vals"] = fp["vals"] * s
        fp["sum"] *= s
        fp["sumsq"] *= s * s


def _shift_sum(rank0):
    """The first leaf's sum off by twice the most its bound allows (its
    elements are fewer than the model's parameters)."""
    p = build_model(st.model_config("llama3.2-1b", "tiny")).param_count()
    rank0[0]["params"][0]["sum"] += 2 * st.F32_PARAM_TOL * p


@pytest.mark.parametrize("edit,round_,part", [
    (_bump_param, 1, "params"),
    (_scale_mu, 0, "server_mu"),
    (_shift_sum, 0, "params"),
], ids=["param-2-bounds", "momentum-1e-5", "leaf-sum"])
def test_gate_fails_on_a_perturbed_rank0(rounds, edit, round_, part):
    held = _check(rounds, edit)
    assert not held[round_]["ok"] and not held[round_][part]["ok"]
    others = [h for i, h in enumerate(held) if i != round_]
    assert all(h["ok"] for h in others)


@pytest.mark.parametrize("ulps,ok", [(0, True), (1, True), (2, False)])
def test_bf16_bound_is_one_ulp(ulps, ok):
    """A bf16 leaf: rank 0's sampled values off by ``ulps`` bf16 ulps of
    the reference (its sum and sum of squares left equal)."""
    gen = torch.Generator().manual_seed(0)
    leaf = (torch.randn((64, 96), generator=gen) * 0.05).to(torch.bfloat16)
    assert bool((leaf != 0).all())
    ref_fp = st.fingerprint([leaf], seed=3)
    fp = copy.deepcopy(ref_fp)
    x = leaf.reshape(-1).double()
    ulp = torch.exp2(torch.floor(torch.log2(x.abs())) - 7)
    fp[0]["vals"] = (x + ulps * ulp)[torch.from_numpy(fp[0]["idx"])].numpy()
    res = st._hold(fp, [leaf], ref_fp, "params")
    assert res["ok"] is ok
    assert np.isclose(res["worst_share_of_tol"], float(ulps))


def test_element_bounds():
    leaf = torch.tensor([0.5, -2.0, 0.0, 1e-3])
    mu = st.element_bound(leaf, "server_mu")
    assert torch.equal(mu, torch.full((4,), st.MU_TOL * 2.0, dtype=torch.float64))
    z = st.element_bound(leaf, "server_mu", zero=2, int8=True)
    assert torch.allclose(z, st.INT8_ATOL + st.F32_RTOL * leaf.double().abs())
    assert torch.equal(st.element_bound(leaf, "params"),
                       torch.full((4,), st.F32_PARAM_TOL, dtype=torch.float64))
    b = st.element_bound(leaf.to(torch.bfloat16), "params")
    assert b[0] == 2.0 ** -8 and b[1] == 2.0 ** -6  # one bf16 ulp of 0.5 and of 2


def test_fingerprint_is_float64_sums_and_seeded_coordinates():
    leaves = tree.leaves({"a": torch.arange(10, dtype=torch.float32),
                          "b": torch.ones((3, 4))})
    a, b = st.fingerprint(leaves, seed=7)
    assert a["sum"] == 45.0 and a["sumsq"] == 285.0 and b["sum"] == 12.0
    assert a["vals"].shape == (st.FINGERPRINT_COORDS,)
    assert np.array_equal(a["vals"], a["idx"].astype(np.float64))
    again = st.fingerprint(leaves, seed=7)[0]
    assert np.array_equal(again["idx"], a["idx"])


def test_run_selftest_holds_on_two_cpu_ranks():
    res = st.run_selftest(devices=2, zero=1, device="cpu", check=True, seq_len=16)
    assert res["ok"], res
    assert res["device"] == "cpu" and res["plan"]["num_clients"] == 2
    assert res["inter_client_all_reduces"] == [[1], [1]]
    assert all(h["ok"] for h in res["check"])


@pytest.mark.parametrize("main", [st.main, sharded_selftest.main, fog_selftest.main],
                         ids=["dist.selftest", "sharded_selftest", "fog_selftest"])
def test_entry_points_default_to_the_card(monkeypatch, main):
    """Without ``--device`` the selftests run on CUDA: with no card that
    raises before any rank starts, instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--devices", "2", "--json"])


def test_world_and_mesh_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(st.rank_rounds, 2, {})
    plan = plan_for(st.model_config("llama3.2-1b", "tiny"), device_count=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.build_mesh()
    assert plan.build_mesh(device="cpu").device == CPU
