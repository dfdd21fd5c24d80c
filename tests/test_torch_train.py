"""The port's training launcher (``repro_torch.launch.train``) on the CPU at
``--scale tiny``: rounds, a checkpoint and ``--resume``, the tracker,
the fault flags, ``--devices`` on a world of CPU ranks; and the entry
points of the distributed path still to port (ROADMAP.md queue 1, item
11(b)) raising."""
import json

import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.fl import FLConfig, abstract_fl_state, init_fl_state, make_round_fn
from repro_torch.launch import train
from repro_torch.models import build_model

TINY = ["--device", "cpu", "--scale", "tiny", "--seq-len", "16", "--clients", "8",
        "--batch-per-slot", "2"]


def test_train_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    log = tmp_path / "rounds.jsonl"
    state = train.main(TINY + ["--rounds", "3", "--ckpt-dir", d, "--ckpt-every", "2",
                               "--track", f"jsonl:{log}", "--pallas-agg"])
    assert state.step == 3 and ckpt.latest_step(d) == 2
    assert all(torch.isfinite(p).all() for p in state.params["layers"].values())
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["step"] for r in rows if r.get("event") == "round"] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows if r.get("event") == "round")
    resumed = train.main(TINY + ["--rounds", "5", "--ckpt-dir", d, "--ckpt-every", "2",
                                 "--resume", "--pallas-agg"])
    out = capsys.readouterr().out
    assert "[train] resumed from round 2" in out
    assert "[round    2]" in out.split("resumed")[1] and "[round    4]" in out
    assert resumed.step == 5 and ckpt.latest_step(d) == 4


def test_train_fault_flags_and_fog(capsys):
    state = train.main(TINY + ["--rounds", "2", "--fog-nodes", "2", "--pallas-agg",
                               "--population", "40", "--fault-crash-rate", "0.5",
                               "--fault-retries", "1"])
    assert state.step == 2 and tuple(state.sched.theta_e.shape) == (40,)
    assert "retries=" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--compile-only"]])
def test_mesh_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="item 11"):
        train.main(TINY + ["--rounds", "1"] + flag)


@pytest.mark.parametrize("flags", [[], ["--fog-nodes", "2", "--pallas-agg"]],
                         ids=["client-zero", "pod-fog"])
def test_devices_runs_the_sharded_round(flags):
    """``--devices 4``: the plan's 2 slots on 4 CPU ranks (client 2 × zero 2,
    or pod 2 × client 1 × zero 2 with the pod axis as the fog tier), the
    contract asserted on every rank each round; rank 0's state near the
    single-process run of the same 2 slots: the reduced config trains in
    bf16, and a slot's gradient is the mean of its two zero shares' bf16
    gradients instead of the whole batch's, which moves bf16's last bits
    (measured: 7e-4 at most on the momentum, parameters within
    ``rtol=2e-2, atol=1e-3``)."""
    argv = TINY + ["--rounds", "2", "--reduced"] + flags
    mesh = ["--devices", "4"] + ["--multi-pod"] * ("--fog-nodes" in flags)
    state = train.main(argv + mesh)
    assert state.step == 2 and int(state.server_count) == 2
    single = train.main(argv + ["--slots", "2"])
    for a, b in zip(tree.leaves(state.params), tree.leaves(single.params)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=1e-3)


def test_full_scale_needs_the_card():
    with pytest.raises((ValueError, RuntimeError)):
        train.main(["--device", "cpu", "--scale", "full", "--rounds", "1"])


def test_distributed_entry_points_raise():
    model = build_model(get_reduced("llama3.2-1b"))
    fl = FLConfig(num_clients=8, slots=4)
    with pytest.raises(NotImplementedError, match="item 11"):
        abstract_fl_state(model, fl)


def test_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fl_state(build_model(get_reduced("llama3.2-1b")), FLConfig(num_clients=8,
                                                                         slots=4), 0)


def test_config_validation():
    with pytest.raises(ValueError):
        FLConfig(num_clients=4, slots=8)
    with pytest.raises(ValueError, match="population"):
        FLConfig(num_clients=8, slots=4, population=6)
    with pytest.raises(ValueError, match="fog"):
        FLConfig(num_clients=8, slots=4, fog_nodes=2, aggregator="median")
