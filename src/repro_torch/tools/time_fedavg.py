"""K1, K3 and K4 (the delta pipeline's weighted-sum kernel) alone on the
card at the main paths' shapes, beside torch.addmv / torch.mv and a
one-element kernel; or, with ``--aggregator median`` or ``trimmed``, K3's
robust route (``robust_kernel``) alone.

    PYTHONPATH=src python3 src/repro_torch/tools/time_fedavg.py [--aggregator A]

Run as a file, it times whichever ``repro_torch`` is first on the path, so
another version of the port (an unpacked parent commit) is timed from the
same script and timer with ``PYTHONPATH=<that checkout>/src``; alternate
the two in one call (parent, change, change, parent). Times: CUDA events
over 400 launches behind a queued spin kernel (``chip_smoke.cuda_ms``,
loaded from this checkout's root), each launch on the next of several
buffers that together exceed the 50 MB L2, as the round finds its deltas.
Shapes: K3 and K1 at the cohort (64, 112,766) in float32, K1 there in
bf16 and at kernels_bench's (32, 65,536), K4 at a fog's (16, 112,766)
block of the cohort buffer; ``torch.sum`` over the same bytes as a
yardstick of what the card streams at these sizes. ``--aggregator
median`` / ``trimmed`` times K3's robust route instead, at the slice's
(64, 112,766) and HAR's (64, 156,230) with 70 % of the clients selected
(trim fraction 0.1), beside its library yardsticks on the same buffers:
``torch.median(x[mask], dim=0)``, or ``torch.sort`` + slice + mean over
the selected rows, the boolean gather (a host synchronisation) included.
Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
C, P, FOG = 64, 112_766, 16
NB, DB = 32, 1 << 16


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HAR_P = 156_230  # the HAR MLP, 1152-128-64-6


def time_robust(cs, cu, res: dict, aggregator: str, gen, dev) -> None:
    """K3's median / trimmed route at the slice's and HAR's shapes, each
    launch on the next of four buffers (> L2), beside its library call."""
    for name, p in (("slice", P), ("har", HAR_P)):
        bufs = [(torch.randn((C, p), generator=gen, device=dev).mul_(0.05),
                 torch.randn((p,), generator=gen, device=dev)) for _ in range(4)]
        masks = [torch.rand((C,), generator=gen, device=dev) < 0.7 for _ in range(4)]
        w = torch.ones((C,), device=dev)
        rows = [cu.pipeline_rows(u, m, w, None, 0.0, 0.1, clip_norm=0.0, compression="none",
                                 topk_fraction=0.05, seg_sizes=None, aggregator=aggregator)
                for (u, _), m in zip(bufs, masks)]
        out = torch.empty((p,), device=dev)

        def k3(i):
            (upd, base), (wn, cnt, pre, seg, tab) = bufs[i % 4], rows[i % 4]
            cu.launch_pipeline(upd, base, wn, cnt, pre, seg, tab, None, None, out, None,
                               lr=1.0, server_momentum=0.9, compression="none",
                               aggregator=aggregator, server_optimizer="fedavg")

        k_trim = [int(0.1 * int(m.sum())) for m in masks]

        def lib(i):
            x = bufs[i % 4][0][masks[i % 4]]
            if aggregator == "median":
                return torch.median(x, dim=0)
            k = k_trim[i % 4]
            return torch.sort(x, dim=0).values[k:x.shape[0] - k].mean(dim=0)

        res[f"{aggregator}_{name}_ms"] = cs.cuda_ms(k3, 400)
        res[f"{aggregator}_{name}_library_ms"] = cs.cuda_ms(lib, 100)
        res[f"{aggregator}_{name}_P"] = p
        del bufs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--aggregator", choices=("fedavg", "median", "trimmed"),
                    default="fedavg", help="K3's route to time (default: the "
                    "weighted-sum kernels K1, K3 and K4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fedavg: needs a CUDA device")
    cs = _smoke()
    cu = importlib.import_module("repro_torch.kernels.delta_pipeline.delta_pipeline")
    fa = importlib.import_module("repro_torch.kernels.fedavg.fedavg")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = {"device": smi, "port": str(Path(cu.__file__).resolve().parents[4])}
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    if args.aggregator != "fedavg":
        time_robust(cs, cu, res, args.aggregator, gen, dev)
        print(json.dumps(res), flush=True)
        return

    def buffers(n, c, p, dtype):
        return [(torch.randn((c, p), generator=gen, device=dev).mul_(0.05).to(dtype),
                 torch.randn((p,), generator=gen, device=dev).to(dtype)) for _ in range(n)]

    mask = torch.rand((C,), generator=gen, device=dev) < 0.7
    w = torch.rand((C,), generator=gen, device=dev) * 300 + 10
    row = fa.weight_row(mask, w, 1.0)
    dm = mask.float() * w
    cohort = buffers(4, C, P, torch.float32)  # 115 MB
    out = torch.empty((P,), device=dev)

    def k3(i):
        upd, base = cohort[i % 4]
        cu.launch_pipeline(upd, base, row, None, None, None, None, None, None, out, None,
                           lr=1.0, server_momentum=0.9, compression="none",
                           aggregator="fedavg", server_optimizer="fedavg")

    res["k3_ms"] = cs.cuda_ms(k3, 400)
    res["k1_f32_ms"] = cs.cuda_ms(lambda i: fa.launch_fedavg(*cohort[i % 4], row, out), 400)
    res["addmv_f32_ms"] = cs.cuda_ms(
        lambda i: torch.addmv(cohort[i % 4][1], cohort[i % 4][0].t(), row, out=out), 400)
    # a read of the same bytes with one output: what the card streams here
    res["sum_f32_ms"] = cs.cuda_ms(lambda i: torch.sum(cohort[i % 4][0]), 400)
    blocks = [(upd[f * FOG:(f + 1) * FOG], dm[f * FOG:(f + 1) * FOG].contiguous())
              for upd, _ in cohort for f in range(C // FOG)]
    res["k4_ms"] = cs.cuda_ms(
        lambda i: cu.launch_partial(*blocks[i % 16], None, None, None, out,
                                    compression="none"), 400)
    res["mv_ms"] = cs.cuda_ms(
        lambda i: torch.mv(blocks[i % 16][0].t(), blocks[i % 16][1], out=out), 400)
    res["sum_fog_ms"] = cs.cuda_ms(lambda i: torch.sum(blocks[i % 16][0]), 400)
    del cohort, blocks
    cohort16 = buffers(8, C, P, torch.bfloat16)  # 115 MB
    out16 = torch.empty((P,), dtype=torch.bfloat16, device=dev)
    row16 = row.to(torch.bfloat16)
    res["k1_bf16_ms"] = cs.cuda_ms(
        lambda i: fa.launch_fedavg(*cohort16[i % 8], row, out16), 400)
    res["addmv_bf16_ms"] = cs.cuda_ms(
        lambda i: torch.addmv(cohort16[i % 8][1], cohort16[i % 8][0].t(), row16, out=out16),
        400)
    del cohort16
    bench = buffers(8, NB, DB, torch.float32)  # 67 MB
    row_b = fa.weight_row(torch.ones((NB,), dtype=torch.bool, device=dev),
                          torch.ones((NB,), device=dev), 1.0)
    outb = torch.empty((DB,), device=dev)
    res["k1_bench_ms"] = cs.cuda_ms(lambda i: fa.launch_fedavg(*bench[i % 8], row_b, outb), 400)
    res["addmv_bench_ms"] = cs.cuda_ms(
        lambda i: torch.addmv(bench[i % 8][1], bench[i % 8][0].t(), row_b, out=outb), 400)
    x = torch.zeros(1, device=dev)
    res["one_element_add_ms"] = cs.cuda_ms(lambda i: x.add_(1), 400)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
