"""Federated runtime of the port: the LM round and its state, the dense
synchronous simulator and their delta-path helpers."""
from repro_torch.fl.round import AttackConfig, make_round_fn
from repro_torch.fl.state import FLConfig, FLState, abstract_fl_state, init_fl_state

__all__ = [
    "AttackConfig",
    "FLConfig",
    "FLState",
    "abstract_fl_state",
    "init_fl_state",
    "make_round_fn",
]
