"""K6 (the RWKV6 recurrence) alone on the card at the rwkv6 serving
prefill's shapes, beside its bound and a one-element kernel.

    PYTHONPATH=src python3 src/repro_torch/tools/time_wkv6.py

Run as a file, it times whichever ``repro_torch`` is first on the path, so
another version of the port (an unpacked parent commit) is timed from the
same script and timer with ``PYTHONPATH=<that checkout>/src``; alternate
the two in one call (parent, change, change, parent). Times: CUDA events
over 400 launches behind a queued spin kernel (``chip_smoke.cuda_ms``,
loaded from this checkout's root) on one set of inputs, which stays in
L2 as the layer leaves it. Shapes (B, T, H) with K = V = 64: one prompt
(1, 128, 32) in bf16 and in float32, the smoke's batched prefill of 16
prompts (16, 128, 32) and a long prompt (1, 2048, 32) in bf16, with the
bounds of ``chip_smoke.k6_bound``; the kernel's plan where the library
reports one. Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
SHAPES = [("prefill", 1, 128, 32, "bfloat16"), ("prefill_f32", 1, 128, 32, "float32"),
          ("batched", 16, 128, 32, "bfloat16"), ("long", 1, 2048, 32, "bfloat16")]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_wkv6: needs a CUDA device")
    cs = _smoke()
    ops = importlib.import_module("repro_torch.kernels.wkv6.ops")
    wk = importlib.import_module("repro_torch.kernels.wkv6.wkv6")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lib = wk.library().lib
    res = {"device": smi, "port": str(Path(wk.__file__).resolve().parents[4])}
    if hasattr(lib, "fedfog_wkv6_plan"):
        res["plan"] = cs.wkv6_plan(lib, 1, 32)
    for name, b, t, h, dtype in SHAPES:
        r, k, v, w, u = cs.wkv6_inputs(torch, b, t, h, dtype, (-4.0, 0.5), False, 9, dev)
        w_min = ops.w_floor(w.dtype)
        res[f"{name}_ms"] = cs.cuda_ms(lambda i: wk.wkv6_cuda(r, k, v, w, u, w_min=w_min), 400)
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"], _, _ = cs.k6_bound(b, t, h, dtype)
        del r, k, v, w, u
    x = torch.zeros(1, device=dev)
    res["one_element_add_ms"] = cs.cuda_ms(lambda i: x.add_(1), 400)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
