"""K5 and K7 alone on the card, at the llama3.2-1b serving slice's shapes
and smaller ones, beside SDPA and a one-element kernel.

    PYTHONPATH=src python3 src/repro_torch/tools/time_attention.py

Run as a file, it times whichever ``repro_torch`` is first on the path, so
another version of the port (an unpacked parent commit) is timed from the
same script and timer with ``PYTHONPATH=<that checkout>/src``; alternate
the two in one call (parent, change, change, parent). Times: CUDA events
over 400 launches behind a queued spin kernel (``chip_smoke.cuda_ms``,
loaded from this checkout's root), inputs as the path leaves them (in
L2). K5: bf16 prefill, B 1, 32 query and 8 kv heads of 64, causal, at
Sq = Sk = 128 (the slice), 64 and 16. K7: bf16 decode, 8 slots of
129..160 tokens in 10 pages of 16 (the slice), one such slot, one
one-page slot. Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[3]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_attention: needs a CUDA device")
    cs = _smoke()
    fa = importlib.import_module("repro_torch.kernels.flash_attention.flash_attention")
    pa = importlib.import_module("repro_torch.kernels.paged_attention.paged_attention")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"device": smi, "port": str(Path(fa.__file__).resolve().parents[4])}
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    h, hkv, hd = 32, 8, 64
    for s in (128, 64, 16):
        q, k, v = (torch.randn(x, generator=gen, device=dev).to(torch.bfloat16) for x in
                   ((1, s, h, hd), (1, s, hkv, hd), (1, s, hkv, hd)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        res[f"k5_ms_s{s}"] = cs.cuda_ms(lambda i: fa.flash_attention_cuda(q, k, v), 400)
        res[f"sdpa_ms_s{s}"] = cs.cuda_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 400)
    for name, slots, n_pages, lengths in (("slice", 8, 10, None), ("one_slot", 1, 10, [150]),
                                          ("one_page", 1, 1, [16])):
        pq, kp, vp, table, lens = cs.paged_inputs(torch, slots, hkv, h // hkv, hd, cs.PAGE,
                                                  n_pages, "bfloat16", lengths, 8, dev)
        res[f"k7_ms_{name}"] = cs.cuda_ms(
            lambda i: pa.paged_attention_cuda(pq, kp, vp, table, lens), 400)
    x = torch.zeros(1, device=dev)
    res["one_element_add_ms"] = cs.cuda_ms(lambda i: x.add_(1), 400)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
