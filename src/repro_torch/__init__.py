"""PyTorch/CUDA port of the FedFog reproduction package (``repro``).

``repro_torch/<sub>/<mod>.py`` is the counterpart of ``repro/<sub>/<mod>.py``
with the same public names. The package imports ``torch``, numpy and the
standard library only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a CUDA device and without an explicit
``"cpu"`` they raise (see :func:`repro_torch.device.resolve_device`).

Random draws go through a draw provider (:mod:`repro_torch.random`), so a
test can hand the port the JAX package's own draws.
"""
