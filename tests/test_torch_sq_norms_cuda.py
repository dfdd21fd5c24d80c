"""K2 (``delta_sq_norms``, the clip gate's per-client Σx²), the
hand-written CUDA kernel, against its plain version on the card, at rows
of one block's span (``NORM_COLS`` columns or fewer: one block per
client) and of several (the span sums added by the second kernel in a
fixed order), numpy-seeded inputs. These need a CUDA card and skip
without one; the file imports no JAX:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_sq_norms_cuda.py

Tolerance: 1e-5 of the largest norm (float32 sums in another order), as
``chip_smoke.py`` holds K2; and run to run bit for bit (fixed order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delta_pipeline import delta_sq_norms_ref
from repro_torch.kernels.delta_pipeline.delta_pipeline import NORM_COLS, delta_sq_norms_cuda

CASES = [(64, 112_766), (3, NORM_COLS), (3, NORM_COLS + 1), (4, 3 * NORM_COLS + 77),
         (1, 5_000_000)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", CASES)
def test_sq_norms_match_plain(c, p):
    dev = _card()
    x = torch.from_numpy(
        np.random.default_rng(c + p).standard_normal((c, p)).astype(np.float32)).to(dev)
    got = delta_sq_norms_cuda(x)
    want = delta_sq_norms_ref(x)
    assert got.shape == (c,) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5 * float(want.max()))
    assert torch.equal(delta_sq_norms_cuda(x), got)
