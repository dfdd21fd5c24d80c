"""``repro_torch.sim.faas`` (the function-style façade over
``sim.des.RoundCostModel``) against the JAX package's ``repro.sim.faas``
on the same numpy-seeded profiles and masks, every policy: floats to
rtol 1e-6 (float32 reductions rounded in another order), the masked
``per_client`` vector exactly 0 where a client is not selected."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.data.telemetry import DeviceProfiles as JProf
from repro.sim import faas as jfaas
from repro_torch.data.telemetry import DeviceProfiles as TProf
from repro_torch.sim import faas as tfaas

N_PARAMS = 112_766


def _inputs(seed, n=16):
    rng = np.random.default_rng(seed)
    prof = dict(
        mips=rng.uniform(3e8, 1.5e9, n), bw_up=rng.uniform(5e5, 6e6, n),
        bw_down=rng.uniform(2e6, 2.4e7, n), rtt_ms=rng.uniform(10, 60, n),
        battery_capacity_j=rng.choice([8e3, 40e3, 15e3], n),
    )
    prof = {k: v.astype(np.float32) for k, v in prof.items()}
    sel, warm = rng.random(n) < 0.5, rng.random(n) < 0.5
    return (JProf(**{k: jnp.asarray(v) for k, v in prof.items()}),
            TProf(**{k: torch.from_numpy(v) for k, v in prof.items()}), sel, warm)


@pytest.mark.parametrize("policy", ["fedfog", "rcs", "fogfaas", "vanilla"])
@pytest.mark.parametrize("seed", [0, 1])
def test_round_times_and_energy_match_jax(policy, seed):
    jp, tp, sel, warm = _inputs(seed)
    cfg_j, cfg_t = jfaas.FaasSimConfig(), tfaas.FaasSimConfig()
    args = (6.0 * N_PARAMS * 96, 2.0 * N_PARAMS, 2.0 * N_PARAMS)
    ref = jfaas.round_times_ms(cfg_j, jp, jnp.asarray(sel), jnp.asarray(warm), *args,
                               policy=policy)
    got = tfaas.round_times_ms(cfg_t, tp, torch.from_numpy(sel), torch.from_numpy(warm),
                               *args, policy=policy)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    assert (got[0].numpy()[~sel] == 0).all()  # per_client masked
    e_ref = jfaas.round_energy_j(cfg_j, jp, jnp.asarray(sel), jnp.asarray(warm), *args[:2])
    e_got = tfaas.round_energy_j(cfg_t, tp, torch.from_numpy(sel), torch.from_numpy(warm),
                                 *args[:2])
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_ref), rtol=1e-6)
    assert (e_got.numpy()[~sel] == 0).all()
