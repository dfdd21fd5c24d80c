from repro_torch.optim.optimizers import clip_by_global_norm, global_norm

__all__ = ["clip_by_global_norm", "global_norm"]
