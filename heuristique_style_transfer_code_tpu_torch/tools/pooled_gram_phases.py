"""Where ``pooled_gram_fwd``'s time goes on one GPU: the kernel against
builds of ``csrc/gram.cu`` with its phases taken out.

    python -m heuristique_style_transfer_code_tpu_torch.tools.pooled_gram_phases

Variants, each compiled from the source with one edit:

  full         the kernel as shipped
  no_sums      the per-stage bin sums left out (the products read what the
               shared buffer holds): the stream, the products, the setup
               and the cluster reduction
  stream_only  bin sums and products left out: the TMA stream of F, the
               per-stage barrier, the setup and the cluster reduction

Each is timed by CUDA-graph replay at the classification path's four
shapes (S = 7, batch 8) in f32 and bf16, at the split count the wrapper
plans. Only ``full`` computes G. Prints one JSON object and writes it to
``chiprun_out/pooled_gram_phases.json`` when that directory exists.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops.kernels import gram as kg
from ..ops.kernels._nvcc import NVCC_FLAGS, _nvcc

SHAPES = [(8, 56, 56, 256), (8, 28, 28, 512), (8, 14, 14, 1024), (8, 7, 7, 2048)]
S = 7
SUMS = "    if (summing) sum_bins(st);\n"
PRODUCTS = ("    if (st > 0 && q < groups) add_products(st - 1);\n",
            "  if (stages > 0 && q < groups) add_products(stages - 1);\n")


def _variants(src: str) -> dict:
    for anchor in (SUMS, *PRODUCTS):
        if anchor not in src:
            raise RuntimeError(f"csrc/gram.cu no longer holds {anchor.strip()!r}")
    no_sums = src.replace(SUMS, "")
    stream_only = no_sums
    for anchor in PRODUCTS:
        stream_only = stream_only.replace(anchor, "")
    return {"full": src, "no_sums": no_sums, "stream_only": stream_only}


def _time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pooled_gram_phases needs a GPU")
    dev = torch.device("cuda")
    with open(kg.LIBRARY.source) as f:
        variants = _variants(f.read())
    libs = {}
    with tempfile.TemporaryDirectory(prefix="pooled_gram_phases_") as tmp:
        procs = {}
        for name, src in variants.items():
            path = os.path.join(tmp, f"{name}.cu")
            with open(path, "w") as f:
                f.write(src)
            procs[name] = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"), path],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
            lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
            kg._bind(lib)
            libs[name] = lib
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, c in SHAPES:
            hw = h * w
            x = torch.relu(torch.randn((n, hw, c), device=dev, generator=gen)).to(dtype)
            g = torch.empty((n, S, S), device=dev, dtype=dtype)
            splits, _ = kg._pooled_gram_plan(n, hw, kg._sm_count(dev))
            row = {"shape": [n, h, w, c], "dtype": str(dtype).split(".")[1], "splits": splits}
            for name, lib in libs.items():
                def call(lib=lib, name=name):
                    kg.check(name, lib.hst_pooled_gram_fwd(
                        x.data_ptr(), g.data_ptr(), None, n, hw, c, S, splits,
                        kg._DTYPE_CODE[dtype], kg._stream(dev)))
                row[f"{name}_ms"] = _time_ms(call)
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"device": torch.cuda.get_device_name(0), "rows": rows}
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "pooled_gram_phases.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
