"""The fused masked-weighted FedAvg apply: K1.

``ops.fedavg_apply`` / ``ops.fedavg_apply_tree`` are the public entry
points; ``ref.fedavg_apply_ref`` is the plain version.
"""
from repro_torch.kernels.fedavg.ops import fedavg_apply, fedavg_apply_tree
from repro_torch.kernels.fedavg.ref import fedavg_apply_ref

__all__ = ["fedavg_apply", "fedavg_apply_tree", "fedavg_apply_ref"]
