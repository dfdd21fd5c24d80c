"""The static engine under mesh rules on 2 CPU ranks (gloo), batch-parallel
on the scaled plan of 2 devices (2 rows of a batch of 4 a rank,
replicated weights, the tokens gathered once at the end), for the
VLM and ENCDEC families: internvl2-2b (8 patch embeddings prepended to
each row, which the cache holds too) and seamless-m4t-medium (source
frames through the encoder, the decoder's self- and cross-attention
caches). (The SSM and HYBRID families are in
``test_torch_serve_dist_ssm_hybrid.py``.) Each
reduced config in float32 with the JAX parameters carried across,
against the JAX package's single-device static path (``prefill`` then
greedy ``decode_step``): the tokens equal, the first decode step's
logits within ``_serve_dist_jax.STATIC_TOL`` and no collective in a
decode step.
"""
import pytest
from _serve_dist_jax import hold_static
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch.dist.world import World


@pytest.fixture(scope="module")
def world():
    with World(2, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


FAMILIES = ["internvl2-2b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_parallel_static_engine_matches_jax(world, arch):
    _, out = hold_static(world, arch, None, 4)
    assert [r["rows"] for r in out] == [(0, 2), (2, 4)]
    assert all(r["kind"] == "batch" and r["census"] == {} for r in out)


