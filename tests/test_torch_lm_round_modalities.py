"""The port's LM round (``repro_torch.fl.round``) against the JAX
package's on the two families whose batches carry a modality input
beside the tokens: internvl2-2b (VLM, ``patch_embeds``) and
seamless-m4t-medium (ENCDEC, ``frames``), reduced in float32, three
rounds from one state on the JAX package's draws. The round splits each
modality input by slot as it splits the tokens, and ``Model.loss`` takes
it; held as ``_lm_parity.check_rounds`` holds llama3.2-1b (every metric,
the final parameters, the server momentum and the scheduler state, to
the tolerances stated there).
"""
import numpy as np
import pytest
from _lm_parity import (
    F32,
    MODEL_TOL,
    batches,
    configs,
    hold_metrics,
    hold_state,
    one_thread,  # noqa: F401 (autouse)
    run_both,
)

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.models import build_model

# (arch, modality key, rows per example)
CASES = [("internvl2-2b", "patch_embeds", 4), ("seamless-m4t-medium", "frames", 6)]


@pytest.mark.parametrize("arch,key,rows", CASES, ids=[c[0] for c in CASES])
def test_round_with_modality_inputs_matches_jax(arch, key, rows):
    jfl, tfl = configs({})
    jm = jax_build(jax_reduced(arch, **F32))
    tm = build_model(get_reduced(arch, **F32))
    rng = np.random.default_rng(9)
    bs = batches(tfl.num_clients, 3, seq=17)
    for b in bs:
        b[key] = rng.standard_normal((b["tokens"].shape[0], rows, 64)).astype(np.float32)
    js, jms, ts, tms = run_both(jm, tm, jfl, tfl, bs)
    hold_metrics(jms, tms)
    hold_state(js, ts, MODEL_TOL)
    assert all(np.isfinite(float(m["loss"])) for m in tms)
