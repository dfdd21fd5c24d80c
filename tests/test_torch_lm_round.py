"""The port's LM round against the JAX package's, three rounds from one
state on the same batches (tolerances in ``_lm_parity.py`` unless a
case states its own): (i) the default configuration (FedAvgM on the
reference aggregation), (ii) the kernel path (K3's plain version,
momentum route), (iii) the fog tier (K4's plain version per fog) over a
population window, and (iv) the RCS, FogFaaS and vanilla slot policies;
and (ix) the slice as a whole: ``examples/quickstart.py``'s own
configuration and batches, five rounds. Cases (v)-(viii) are in
``test_torch_lm_round_more.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _lm_parity import check_rounds, hold_leaves, hold_metrics, one_thread  # noqa: F401

from repro.core.scheduler import SchedulerConfig as JaxSched
from repro.fl import FLConfig as JaxFL
from repro.fl import init_fl_state as jax_init
from repro.fl import make_round_fn as jax_make
from repro.models import Family as JaxFamily
from repro.models import ModelConfig as JaxModelConfig
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl import FLConfig, make_round_fn
from repro_torch.models import build_model
from repro_torch.models.config import Family, ModelConfig


@pytest.mark.parametrize("over", [
    {},
    dict(use_pallas_agg=True),
    dict(use_pallas_agg=True, fog_nodes=2, population=64),
    dict(policy="rcs"),
    dict(policy="fogfaas"),
    dict(policy="vanilla"),
], ids=["default", "kernel-momentum", "fog-population", "rcs", "fogfaas", "vanilla"])
def test_round_matches_jax(over):
    jms, _ = check_rounds(over)
    assert sum(int(m["slot_participation"]) for m in jms) > 0  # something trained in


# bf16 parameters: every weight is rounded to bf16 after each local step,
# each delta and each server update, so a sum that XLA and ATen order
# differently can land one bf16 ulp (2^-8 relative) apart, and the next
# roundings carry it on. Parameters and momentum are held to two ulps of
# their magnitude plus 2e-3 absolute for all but 0.1 % of each leaf (a few
# elements a leaf chained more roundings apart), and every element to
# the rounding chain's reach: five rounds of three bf16 roundings (two
# local steps and the server update) of at most 2^-9 each at |w| < 0.5,
# 15 · 2^-9 ≈ 0.03. The loss to 1e-3.
BF16_TOL = dict(rtol=2.0**-7, atol=2e-3)
BF16_LOOSE = 0.001
BF16_CAP = dict(rtol=0.0, atol=0.03)


def _quickstart(pkg):
    mc, fl, sc, fam = ((JaxModelConfig, JaxFL, JaxSched, JaxFamily) if pkg == "jax"
                       else (ModelConfig, FLConfig, SchedulerConfig, Family))
    cfg = mc(name="quickstart-lm", family=fam.DENSE, num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
             remat=False, loss_chunk=0)
    return cfg, fl(num_clients=16, slots=4, local_steps=2,
                   scheduler=sc(theta_h=0.6, theta_e=0.5, theta_d=0.1))


def test_quickstart_matches_jax():
    """``examples/quickstart.py`` (lines 17-31 and 38-47): its model, its
    FLConfig, its five rounds on the batches it builds, handed over as
    numpy arrays; the JAX side keeps its own copy of the state."""
    jcfg, jfl = _quickstart("jax")
    tcfg, tfl = _quickstart("torch")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    key = jax.random.PRNGKey(0)
    js = jax_init(jm, jfl, key)
    js_np = jax.tree.map(np.asarray, js)
    ts = convert.fl_state_from_jax(tcfg, js_np, device="cpu")
    jr = jax.jit(jax_make(jm, jfl, flops_per_client_round=1e9))
    tr = make_round_fn(tm, tfl, flops_per_client_round=1e9,
                       draws=JaxDraws(0, fl_rng=js_np.rng))
    jms, tms = [], []
    for _ in range(5):
        key, k = jax.random.split(key)
        ks = jax.random.split(k, 7)
        batch = {
            "tokens": jax.random.randint(ks[0], (16, 33), 0, jcfg.vocab_size),
            "slot_data_sizes": jnp.array([100.0, 220.0, 80.0, 150.0]),
            "telemetry_cpu": jax.random.uniform(ks[1], (16,), minval=0.4, maxval=1.0),
            "telemetry_mem": jax.random.uniform(ks[2], (16,), minval=0.4, maxval=1.0),
            "telemetry_batt": jax.random.uniform(ks[3], (16,), minval=0.3, maxval=1.0),
            "telemetry_energy": jax.random.uniform(ks[4], (16,), minval=0.4, maxval=1.0),
            "hist": jnp.abs(jax.random.normal(ks[5], (16, jfl.hist_bins))) + 1.0,
        }
        host = {k: np.asarray(v) for k, v in batch.items()}
        js, m = jr(js, batch)
        jms.append(jax.tree.map(np.asarray, m))
        with torch.no_grad():
            ts, m = tr(ts, {k: torch.from_numpy(v.copy()) for k, v in host.items()})
        tms.append(m)
    for mj, mt in zip(jms, tms):
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-3)
        mj.pop("loss"), mt.pop("loss")
    hold_metrics(jms, tms)
    assert sum(int(m["slot_participation"]) for m in jms) > 0
    hold_leaves(js.params, ts.params, BF16_TOL, BF16_LOOSE, cap=BF16_CAP)
    hold_leaves(js.server_mu, ts.server_mu, BF16_TOL, BF16_LOOSE, "server_mu", BF16_CAP)
    np.testing.assert_array_equal(ts.rng, np.asarray(js.rng))
    assert ts.step == int(js.step) == 5
