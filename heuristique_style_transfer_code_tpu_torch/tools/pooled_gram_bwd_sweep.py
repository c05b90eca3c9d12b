"""Launch configurations of ``pooled_gram_bwd`` on one GPU.

    python -m heuristique_style_transfer_code_tpu_torch.tools.pooled_gram_bwd_sweep

At the family-2 training step's b32 stage outputs (S 7), f32 and bf16, from
the forward kernel's Y and a signed, non-symmetric dG: the plan's choice,
then each tile size (dF bytes a tile) and blocks an SM, each output
bit-equal to the plan's (the tiling does not change a sum) and timed by
CUDA-graph replay; beside them the plain version, the library yardstick
(autograd through the two-einsum composition, less its forward), a
write-only yardstick (``zero_`` of a dF-sized tensor: what the card's
memory takes to be written once) and the bound (Y and dG read, dF written
at 3.35 TB/s).
Then the bulk mode's store walks at the plan, each a build of
``csrc/gram.cu`` with one edit, timed in three interleaved rounds:

  kept             the kernel as shipped: where the groups of a row divide
                   the block, a thread keeps its group (and, where one bin
                   holds the whole group, stores that bin's z) on every row
  kept_no_one_bin  the kept group without the one-bin case
  carried          the (row, group) walk with a carry, as the scalar mode
                   walks channels

Prints one JSON line a row and writes everything to
``chiprun_out/pooled_gram_bwd_sweep.json`` when that directory exists.

It measures the choices ``_pooled_gram_bwd_plan`` makes; it is not part of
the port's path.
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
from ..ops.pooling import adaptive_pool_matrix
from .pooled_gram_phases import _time_ms

SHAPES = [(32, 56, 56, 256), (32, 28, 28, 512), (32, 14, 14, 1024)]
S = 7
TILE_BYTES = (8192, 16384, 32768, 65536)
BLOCKS_PER_SM = (2, 4, 6, 8)
HBM = 3.35e12  # H100 SXM bytes/s
KEPT = "      if (step_i == 0) {\n"
ONE_BIN = "        if (e >> 8 == 1) {  // one bin holds the whole group\n"


def _walk_variants(src: str) -> dict:
    for anchor in (KEPT, ONE_BIN):
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/gram.cu no longer holds {anchor.strip()!r} once")
    return {"kept": src,
            "kept_no_one_bin": src.replace(ONE_BIN, "        if (false) {\n"),
            "carried": src.replace(KEPT, "      if (false) {\n")}


def _build_walks(tmp: str) -> dict:
    """The walk variants, one nvcc each, all started together; name -> the
    bound library."""
    with open(kg.LIBRARY.source) as f:
        variants = _walk_variants(f.read())
    procs = {}
    for name, src in variants.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        kg._bind(lib)
        libs[name] = lib
    return libs


def _time_walks(libs: dict, y, dg, c: int, dtype, plan, want) -> dict:
    """Each walk's times over three rounds, in turns (the order reversed
    every other round), and whether its dF has the plan's bits."""
    n, hw, s = y.shape
    dev = y.device

    def call(lib):
        df = torch.empty((n, hw, c), device=dev, dtype=dtype)
        kg.check("pooled_gram_bwd", lib.hst_pooled_gram_bwd(
            y.data_ptr(), dg.data_ptr(), df.data_ptr(), n, hw, c, s,
            kg._PGB_MODE_CODE[plan.mode], plan.tile_rows, plan.blocks, kg._DTYPE_CODE[dtype],
            kg._stream(dev)))
        return df

    out = {name: {"same_bits": torch.equal(call(lib), want), "ms": []}
           for name, lib in libs.items()}
    order = list(libs.items())
    for rnd in range(3):
        for name, lib in (order if rnd % 2 == 0 else order[::-1]):
            out[name]["ms"].append(_time_ms(lambda lib=lib: call(lib)))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pooled_gram_bwd_sweep needs a GPU")
    with tempfile.TemporaryDirectory(prefix="pooled_gram_bwd_walks_") as tmp:
        _sweep(_build_walks(tmp))


def _sweep(walks: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        es = torch.tensor([], dtype=dtype).element_size()
        for n, h, w, c in SHAPES:
            hw = h * w
            f = torch.relu(torch.randn((n, hw, c), device=dev, generator=gen)).to(dtype)
            dg = torch.randn((n, S, S), device=dev, generator=gen).to(dtype)
            _, y = kg.pooled_gram_fwd(f, S, return_y=True)
            plan = kg.pooled_gram_bwd_plan_for(y, c, dtype)
            want = kg.pooled_gram_bwd(y, dg, c, dtype)
            plain = kg.pooled_gram_bwd_plain(y, dg, c, dtype).float()
            rel = ((want.float() - plain).abs().max() / plain.abs().max()).item()
            pl = adaptive_pool_matrix(c, S, dev).to(dtype)
            fl = f.detach().clone().requires_grad_(True)

            def lib_fwd():
                yl = torch.einsum("nkc,oc->nko", fl, pl)
                return torch.einsum("nko,nkp->nop", yl, yl) / hw

            zero = torch.empty_like(want)
            row = dict(shape=[n, h, w, c], s=S, dtype=dname, plan=plan._asdict(), rel_err=rel,
                       ms=_time_ms(lambda: kg.pooled_gram_bwd(y, dg, c, dtype)),
                       plain_ms=_time_ms(lambda: kg.pooled_gram_bwd_plain(y, dg, c, dtype)),
                       library_ms=_time_ms(lambda: torch.autograd.grad(lib_fwd(), fl, dg))
                       - _time_ms(lib_fwd),
                       zero_ms=_time_ms(zero.zero_),
                       bound_ms=(n * hw * S * 4 + n * S * S * es + n * hw * c * es) / HBM * 1e3,
                       fwd_ms=_time_ms(lambda: kg.pooled_gram_fwd(f, S)),
                       fwd_y_ms=_time_ms(lambda: kg.pooled_gram_fwd(f, S, return_y=True)),
                       configs=[])
            for tile_bytes in TILE_BYTES:
                for bps in BLOCKS_PER_SM:
                    p = kg.pooled_gram_bwd_plan_for(y, c, dtype, tile_bytes=tile_bytes,
                                                    blocks_per_sm=bps)
                    same = torch.equal(kg.pooled_gram_bwd(y, dg, c, dtype, _plan=p), want)
                    row["configs"].append(dict(
                        mode=p.mode, tile_bytes=tile_bytes, blocks_per_sm=bps,
                        tile_rows=p.tile_rows, blocks=p.blocks, same_bits=same,
                        ms=_time_ms(lambda p=p: kg.pooled_gram_bwd(y, dg, c, dtype, _plan=p))))
            row["walks"] = _time_walks(walks, y, dg, c, dtype, plan, want)
            best = min(row["configs"], key=lambda r: r["ms"])
            print(json.dumps({**{k: v for k, v in row.items() if k != "configs"}, "best": best}),
                  flush=True)
            rows.append(row)
            del f, dg, y, want, plain, fl, zero
    out = {"device": torch.cuda.get_device_name(0), "rows": rows}
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "pooled_gram_bwd_sweep.json"), "w") as fh:
            json.dump(out, fh, indent=1)
    bad = [(r["shape"], r["dtype"], c["tile_bytes"], c["blocks_per_sm"])
           for r in rows for c in r["configs"] if not c["same_bits"]]
    bad += [(r["shape"], r["dtype"], name) for r in rows
            for name, w in r["walks"].items() if not w["same_bits"]]
    if bad:
        raise SystemExit(f"configurations that changed dF's bits: {bad}")


if __name__ == "__main__":
    main()
