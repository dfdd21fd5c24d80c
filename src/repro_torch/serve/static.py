"""The static serving engine: one fixed batch, a prefill and then greedy
decode steps, the tokens written into a device buffer that is read once
at the end (port of the static path of ``repro/launch/serve.py``), on one
device or on one rank under mesh rules.

Under rules (:func:`serve_runtime`, ``dist.sharding.ServeLayout``) a rank
serves, as the JAX launcher's shardings split the batch:

  * "batch": its rows of the batch, with its weights (replicated, or its
    blocks under a model split); the whole batch's tokens are gathered
    over the data axes once, at the end (the JAX launcher's one terminal
    sync);
  * "sequence": every row, on its span of the prompt and of the cache
    (``Runtime.sequence``, DENSE only);
  * "replicated": everything, as JAX's ``P()``.

A model split (``Runtime.tensor``) composes with each. MoE under rules
raises: the JAX launcher switches it to ``moe_impl="gshard"`` on the mesh,
which the port does not execute (ROADMAP item 11(b), step 3).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.transformer import Runtime, greedy

_MOE = ("the MoE family under mesh rules (moe_ffn_gshard(mesh=...), the expert axis) "
        "is not executed yet: ROADMAP.md queue 1, item 11(b), step 3")


def serve_runtime(rules, batch: int | None = None, prompt_len: int | None = None) -> Runtime:
    """The serving ``Runtime`` of one rank under mesh ``rules``: its
    tensor-parallel view (a model split) and, for a static (batch,
    prompt_len) batch, its sequence split. Raises for MoE and for what
    ``TensorParallel.from_rules`` refuses."""
    from repro_torch.dist.tensor_parallel import SequenceParallel, TensorParallel

    if rules.cfg.num_experts:
        raise NotImplementedError(f"{rules.cfg.name}: {_MOE}")
    tp = TensorParallel.from_rules(rules)
    seq = None if batch is None else SequenceParallel.from_rules(rules, batch, prompt_len)
    return Runtime(tensor=tp, sequence=seq)


def serving_params(params, runtime: Runtime):
    """The parameters a rank serves from: its blocks, with the ``qk_norm``
    scales whole (``TensorParallel.serving_params``) under a model split."""
    tp = runtime.tensor
    return params if tp is None else tp.serving_params(params)


@dataclasses.dataclass
class StaticResult:
    """One static run, on the host except the logits."""

    tokens: np.ndarray  # (B, gen) int32: every row's, on every rank
    prefill_ms: float
    decode_ms: float  # wall ms per decode step
    rows: tuple[int, int]  # the batch rows this rank served
    first_logits: torch.Tensor | None  # first decode step's (rows, V or V_local) f32


def decode_census(model, params, rows: int, cache_len: int, pos: int, runtime: Runtime,
                  device):
    """The collectives (``CollectiveStats``) of one static decode step and
    its greedy pick, read off a step over a zeroed cache of the rank's
    block at position ``pos``: the program every step runs. Every rank of
    the runtime's groups must call it together; without a tensor or
    sequence view it makes none and is not run."""
    from repro_torch.dist.collectives import CollectiveLog, CollectiveStats

    if runtime.tensor is None and runtime.sequence is None:
        return CollectiveStats()
    params = serving_params(params, runtime)
    cache = model.init_cache(rows, cache_len, device=device, runtime=runtime)
    cache["pos"] = pos
    tokens = torch.zeros((rows, 1), dtype=torch.int64, device=device)
    with CollectiveLog() as log, torch.no_grad():
        logits, _ = model.decode_step(params, cache, tokens, runtime)
        greedy(logits[:, -1], runtime)
    return log.stats()


def serve_static(model, params, batch: dict, cache_len: int, gen: int, *, rules=None,
                 tap=None, keep_logits: bool = False) -> StaticResult:
    """Prefill ``batch`` (the whole batch's inputs, on the parameters'
    device) and decode ``gen - 1`` greedy steps; under mesh ``rules`` this
    rank's share (see the module docstring). ``tap`` gets one host row a
    step. ``keep_logits`` keeps the first decode step's logits."""
    from repro_torch.dist.tensor_parallel import _all_gather

    tokens = batch["tokens"]
    b, s = tokens.shape
    device = tokens.device
    runtime, layout = Runtime(), None
    if rules is not None:
        runtime = serve_runtime(rules, b, s)
        layout = rules.serve_layout(b, s)
        params = serving_params(params, runtime)
    lo, hi = layout.rows if layout is not None else (0, b)
    local = {k: v[lo:hi] for k, v in batch.items()}
    out = torch.zeros((hi - lo, gen), dtype=torch.int32, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    first = None
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, local, cache_len=cache_len, runtime=runtime)
        toks = greedy(logits[:, -1], runtime)[:, None]
        out[:, 0] = toks[:, 0].int()
        sync()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(1, gen):
            logits, cache = model.decode_step(params, cache, toks, runtime)
            if keep_logits and i == 1:
                first = logits[:, -1]
            toks = greedy(logits[:, -1], runtime)[:, None]
            out[:, i] = toks[:, 0].int()
            if tap is not None:
                tap.host_log({"step": i, "batch": b}, step=i)
        if layout is not None and layout.kind == "batch" and layout.ways > 1:
            whole = torch.empty((layout.ways * out.shape[0], gen), dtype=out.dtype,
                                device=device)
            _all_gather(whole, out, rules.mesh.group(layout.axes))
            out = whole
        host = out.cpu().numpy()  # the one device -> host read
        t_decode = time.perf_counter() - t0
    return StaticResult(tokens=host, prefill_ms=t_prefill * 1e3,
                        decode_ms=t_decode / max(gen - 1, 1) * 1e3, rows=(lo, hi),
                        first_logits=first)
