"""The static engine under mesh rules on 2 CPU ranks (gloo) for the DENSE
configs whose layer differs from llama's, on sp 2 (tp 1): q, k and v
gathered over ``head_dim`` before RoPE, the rank's heads attending with
whole rows, ``wo`` and the MLP row-parallel over sp. qwen2.5-14b's qkv
bias (added to the rank's ``head_dim`` columns before the gather) and
gemma3-12b's ``qk_norm`` (its norm scales made whole once, before
serving, so a decode step gathers only q, k and v), logit softcap, tied
head and sliding windows. Each reduced config in float32 with the JAX
parameters carried across, against the JAX package's single-device
static path: the tokens equal, the first decode step's logits within
``_serve_dist_jax.STATIC_TOL`` and the decode census 2L + 1 all-reduces
and g·L + 1 all-gathers (g = 1).
"""
import pytest
from _serve_dist_jax import hold_static
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch.dist.world import World


@pytest.fixture(scope="module")
def world():
    with World(2, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


@pytest.mark.parametrize("arch,gathers", [("qwen2.5-14b", 1), ("gemma3-12b", 1)])
def test_dense_layers_on_sp2_match_jax(world, arch, gathers):
    cfg, out = hold_static(world, arch, (1, 1, 1, 2), 2)
    n = cfg.num_layers
    want = {"all-reduce": 2 * n + 1, "all-gather": gathers * n + 1}
    assert all(r["kind"] == "replicated" and r["census"] == want for r in out)
