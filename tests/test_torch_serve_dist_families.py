"""The static engine under mesh rules on 2 CPU ranks (gloo) for the DENSE
configs, against the JAX package's single-device static path
(``prefill`` then greedy ``decode_step``), each reduced config in float32
with the JAX parameters carried across, batch-parallel on the scaled
plan of 2 devices (2 rows of a batch of 4 a rank, replicated weights,
the tokens gathered once at the end): llama3.2-1b, qwen2.5-14b, yi-9b
and gemma3-12b. The tokens equal, the first decode step's logits within
``_serve_dist_jax.STATIC_TOL`` and no collective in a decode step. (The
DENSE layers on sp 2 are in ``test_torch_serve_dist_dense_sp.py``, the
other families in ``_ssm_hybrid.py`` and ``_vlm_encdec.py``.)
"""
import pytest
from _serve_dist_jax import hold_static
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch.dist.world import World


@pytest.fixture(scope="module")
def world():
    with World(2, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


FAMILIES = ["llama3.2-1b", "qwen2.5-14b", "yi-9b", "gemma3-12b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_parallel_static_engine_matches_jax(world, arch):
    _, out = hold_static(world, arch, None, 4)
    assert [r["rows"] for r in out] == [(0, 2), (2, 4)]
    assert all(r["kind"] == "batch" and r["census"] == {} for r in out)
