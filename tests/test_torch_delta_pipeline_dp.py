"""The DP-noise half of the delta-pipeline gate matrix (quick scale): the
port's plain version and the model of its CUDA kernel against the JAX
kernel in interpret mode. See ``_pipeline_gates`` for the tolerances and
``test_torch_delta_pipeline.py`` for the other half."""
import pytest
from _pipeline_gates import GATES, check_gate
from _threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize(
    "dp,opt,comp,clip,stale", [g for g in GATES if g[0]], ids=str
)
def test_gate_matrix_quick_dp(dp, opt, comp, clip, stale):
    check_gate("quick", dp, opt, comp, clip, stale)
