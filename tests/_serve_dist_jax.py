"""JAX-side pieces of the serving-under-rules CPU tests: the reduced
configs in float32 and the JAX package's single-device static path
(``Model.prefill`` then greedy ``Model.decode_step``, as
``repro/launch/serve.py`` runs it), jitted once per shape."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build

F32 = dict(param_dtype="float32", compute_dtype="float32")


def jax_setup(arch: str, over: dict | None = None, seed: int = 0):
    """(config, model, parameters as numpy) of the reduced ``arch`` in
    float32 with ``over`` replaced."""
    cfg = dataclasses.replace(jax_reduced(arch, loss_chunk=0, **F32), **(over or {}))
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    return cfg, model, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _programs(model, cache_len: int):
    return (jax.jit(functools.partial(model.prefill, cache_len=cache_len)),
            jax.jit(model.decode_step))


def jax_static(model, params, batch: dict, cache_len: int, steps: int):
    """The prefill of ``batch`` (numpy) and ``steps`` greedy decode steps:
    (every step's last-position logits (B, V) numpy, the tokens (B, steps
    + 1))."""
    prefill, decode = _programs(model, cache_len)
    logits, cache = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    out, toks = [], []
    for i in range(steps + 1):
        out.append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok[:, 0]))
        if i < steps:
            logits, cache = decode(params, cache, tok)
    return out, np.stack(toks, axis=1)


def random_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """Tokens (b, s) and a VLM config's 8 patch embeddings or an ENCDEC
    config's (b, s, d) frames, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)}
    family = cfg.family.value
    if family == "vlm":
        out["patch_embeds"] = rng.standard_normal((b, 8, cfg.d_model)).astype(np.float32)
    if family == "encdec":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return out


STATIC_S, STATIC_GEN = 8, 4  # the static checks' prompt and tokens a row
STATIC_TOL = dict(rtol=1e-5, atol=1e-5)


def hold_static(world, arch: str, split, b: int, over: dict | None = None):
    """``serve.static`` under the case's rules on ``world``
    (``_serve_dist_cases.rank_static``) against the JAX static path on
    the same parameters and batch: on every rank the tokens equal and the
    first decode step's logits within ``STATIC_TOL`` over the true
    vocabulary. Returns (the JAX config, the ranks' results)."""
    from _serve_dist_cases import rank_static

    cfg, jm, jp = jax_setup(arch, over)
    batch = random_batch(cfg, b, STATIC_S, seed=1)
    cache_len = STATIC_S + STATIC_GEN + (8 if cfg.family.value == "vlm" else 0)
    ref_logits, ref_toks = jax_static(jm, jp, batch, cache_len, STATIC_GEN - 1)
    out = world.run(rank_static, dict(arch=arch, over=over, split=split, params=jp,
                                      batch=batch, cache_len=cache_len, gen=STATIC_GEN))
    v = cfg.vocab_size
    for r in out:
        np.testing.assert_array_equal(r["tokens"], ref_toks)
        np.testing.assert_allclose(r["first"][:, :v], ref_logits[1][:, :v], **STATIC_TOL)
    return cfg, out
