"""Shared gate-matrix machinery of the delta-pipeline parity tests.

``check_gate`` runs one gate combination through the JAX kernel (Pallas,
interpret mode, as tests/test_delta_pipeline.py runs it) and through the
port twice:

  * ``repro_torch.kernels.delta_pipeline.delta_pipeline_apply`` on CPU
    tensors, i.e. the plain version (``ref.py``);
  * ``kernel_model``: the CUDA kernel's arithmetic written in torch,
    applied to the rows the CUDA wrapper prepares (``pipeline_rows``:
    Eq. 6 weights with staleness folded in, clip scales, a compression
    table computed on the raw deltas and rescaled), the median / trimmed
    route through ``_robust_network`` (the kernel's sorting network and
    selection). The card cannot run here; this holds the kernel's design
    against the JAX kernel.

Both must equal the JAX kernel bitwise with every gate off (its own
contract against its reference); with gates on, to ``rtol=1e-5`` with
``atol=1e-6`` (a few ulps of the O(1) outputs), or ``atol=5e-3`` under
FedAdam, whose division by ``|agg| + 1e-3`` amplifies last-bit
differences (the JAX package's own tolerance for it).
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _robust_network import robust_aggregate

from repro.kernels.delta_pipeline import delta_pipeline_apply as jax_apply
from repro_torch.kernels.delta_pipeline import delta_pipeline_apply
from repro_torch.kernels.delta_pipeline.delta_pipeline import pipeline_rows
from repro_torch.kernels.delta_pipeline.ref import _fma, delta_sq_norms_ref

SCALES = {
    "quick": dict(c=6, seg_sizes=(40, 8, 64, 16), block_d=64),
    "full": dict(c=32, seg_sizes=(784 * 16, 16, 16 * 62, 62), block_d=2048),
}
GATES = list(
    itertools.product(
        [False, True],  # dp
        ["fedavg", "fedavgm", "fedadam"],  # server optimizer
        ["none", "int8", "topk"],  # compression
        [0.0, 1.5],  # clip
        [False, True],  # staleness
    )
)
# The full scale runs the subset tests/test_delta_pipeline.py runs there.
FULL_GATES = [
    (False, "fedavg", "none", 0.0, False),
    (True, "fedadam", "int8", 1.5, True),
    (True, "fedavgm", "topk", 0.0, True),
    (True, "fedavg", "topk", 1.5, False),
]


def fixture(c, p):
    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    return dict(
        upd=jax.random.normal(ks[0], (c, p)),
        base=jax.random.normal(ks[1], (p,)),
        mask=jax.random.bernoulli(ks[2], 0.7, (c,)),
        weights=jnp.abs(jax.random.normal(ks[3], (c,))) * 100,
        noise=0.1 * jax.random.normal(ks[4], (p,)),
        mu=jax.random.normal(ks[5], (p,)),
        staleness=jnp.arange(c, dtype=jnp.float32) % 4,
    )


def to_torch(fx):
    return {k: torch.from_numpy(np.array(v)) for k, v in fx.items()}


def kernel_transform(upd, pre, seg, tab, compression):
    """The kernels' ``transform``: clip pre-scale, then int8 or top-k
    emulation with each client's table entry for the column's leaf."""
    x = upd.to(torch.float32)
    if pre is not None:
        x = x * pre[:, None]
    if compression != "none":
        col = tab[:, seg.long()]
        if compression == "int8":
            x = torch.clamp(torch.round(x / col), -127.0, 127.0) * col
        else:
            x = x * (torch.abs(x) >= col).to(torch.float32)
    return x


def kernel_model(upd, base, rows, noise, mu, *, lr, server_momentum,
                 compression, aggregator, server_optimizer):
    """The CUDA kernel's per-column arithmetic, in torch, on prepared rows."""
    wn, cnt, pre, seg, tab = rows
    x = kernel_transform(upd, pre, seg, tab, compression)
    if aggregator == "fedavg":
        agg = torch.zeros_like(x[0])
        for c in range(x.shape[0]):
            agg = _fma(wn[c], x[c], agg)
    else:
        num_sel, k_trim = (int(v) for v in cnt)
        agg = robust_aggregate(x, wn > 0, num_sel, k_trim, aggregator)
    if noise is not None:
        agg = agg + noise
    lr32 = torch.tensor(lr, dtype=torch.float32)
    if mu is not None:
        mu2 = server_momentum * mu + agg
        step = lr32 * mu2
        if server_optimizer == "fedadam":
            step = step / (torch.sqrt(agg * agg) + 1e-3)
        return base + step, mu2
    return _fma(lr32, agg, base)


def check_gate(scale, dp, opt, comp, clip, stale):
    shp = SCALES[scale]
    c, seg_sizes, block_d = shp["c"], shp["seg_sizes"], shp["block_d"]
    fx = fixture(c, sum(seg_sizes))
    kw = dict(
        lr=0.7,
        staleness=fx["staleness"] if stale else None,
        staleness_exponent=0.5,
        dp_noise=fx["noise"] if dp else None,
        momentum=fx["mu"] if opt != "fedavg" else None,
        clip_norm=clip,
        compression=comp,
        topk_fraction=0.1,
        seg_sizes=seg_sizes if comp != "none" else None,
        server_optimizer=opt,
        server_momentum=0.9,
    )
    ref = jax_apply(fx["upd"], fx["base"], fx["mask"], fx["weights"],
                    block_d=block_d, **kw)
    refs = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]

    tx = to_torch(fx)
    tkw = dict(kw, staleness=tx["staleness"] if stale else None,
               dp_noise=tx["noise"] if dp else None,
               momentum=tx["mu"] if opt != "fedavg" else None)
    plain = delta_pipeline_apply(tx["upd"], tx["base"], tx["mask"], tx["weights"], **tkw)
    rows = pipeline_rows(
        tx["upd"], tx["mask"], tx["weights"], tkw["staleness"], 0.5, 0.1,
        clip_norm=clip, compression=comp, topk_fraction=0.1,
        seg_sizes=kw["seg_sizes"], aggregator="fedavg", sq_norms=delta_sq_norms_ref,
    )
    model = kernel_model(
        tx["upd"], tx["base"], rows, tkw["dp_noise"], tkw["momentum"], lr=0.7,
        server_momentum=0.9, compression=comp, aggregator="fedavg",
        server_optimizer=opt,
    )
    all_off = not dp and opt == "fedavg" and comp == "none" and clip == 0.0 and not stale
    for got in (plain, model):
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(refs)
        for o, r in zip(got, refs):
            o = o.numpy()
            if all_off:
                np.testing.assert_array_equal(o, r)
            else:
                atol = 5e-3 if opt == "fedadam" else 1e-6
                np.testing.assert_allclose(o, r, rtol=1e-5, atol=atol)
