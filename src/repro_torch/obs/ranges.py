"""Profiler ranges around the phases of a round."""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function


def profiler_range(name: str):
    """A ``torch.profiler`` range ``name`` while a profiler runs (read by
    ``repro_torch.tools.profile_round`` / ``profile_train``); no range
    otherwise, since a range costs the host a dispatcher call even when no
    profiler records it."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()
