from repro_torch.kernels.delta_pipeline.delta_pipeline import segment_table
from repro_torch.kernels.delta_pipeline.ops import (
    delta_pipeline_apply,
    delta_pipeline_partial,
    delta_sq_norms,
)
from repro_torch.kernels.delta_pipeline.ref import (
    delta_pipeline_partial_ref,
    delta_pipeline_ref,
    delta_sq_norms_ref,
)

__all__ = [
    "delta_pipeline_apply",
    "delta_pipeline_partial",
    "delta_pipeline_partial_ref",
    "delta_pipeline_ref",
    "delta_sq_norms",
    "delta_sq_norms_ref",
    "segment_table",
]
