"""Launch configurations of ``instance_norm_fwd``'s cluster route, on one GPU.

    python -m heuristique_style_transfer_code_tpu_torch.tools.instance_norm_sweep

Prints, and writes to ``chiprun_out/instance_norm_sweep.json`` when that
directory exists:

  occupancy  cudaOccupancyMaxActiveClusters for clusters of k = 1..16
             blocks at several shared-memory sizes a block (above half an
             SM's, no two blocks share an SM);
  shapes     at the fast-style net's shapes (B = 8) and at B = 1 and 4 of
             the first, f32 and bf16, with ReLU: the plan's choice, the
             split route, and the cluster route at k = 8, 9, 16,
             every row resident or streamed through two ring sizes, one
             block an SM, or blocks small enough to share an SM; each held
             against the plain version (max error relative to max|plain|)
             and timed by CUDA-graph replay;
  phases     the plan's launch at each shape from a build of the source
             with -DIN_PHASE_TRACE: per block, the time from its start to
             each phase mark (csrc/instance_norm.cu IN_MARK), in ns of
             %globaltimer and in SM cycles of %clock64, mean and max over
             the blocks, and the spread of the blocks' starts.

It measures the choices ``_plan`` makes; it is not part of the port's path.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from ..ops.kernels import instance_norm as kin
from ..ops.kernels._nvcc import NVCC_FLAGS, _nvcc

SHAPES = [(8, 224, 224, 32), (8, 112, 112, 64), (8, 56, 56, 128), (1, 224, 224, 32),
          (4, 224, 224, 32)]
KS = (8, 9, 16)
HALF_SM = 113 * 1024  # a block that leaves room for a second one on its SM
RINGS = ((32 * 1024, 4), (64 * 1024, 3))  # (bytes a stage, slots)
MARKS = 8  # csrc/instance_norm.cu IN_MARKS
SMEM_KB = (64, 113, 120, 226)


def _time_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _occupancy_table() -> dict:
    out = {}
    for kb in SMEM_KB:
        row = []
        for k in range(1, 17):
            # a plan of 1 resident row, padded to the size asked about
            plan = kin.Plan("cluster", k, 1, 1, 0, 0, kb * 1024)
            try:
                # (an image of k rows, so that the one row a block keeps is all of it)
                row.append(kin._occupancy(torch.cuda.current_device(), k, 32, 4, plan))
            except RuntimeError as e:
                row.append(str(e))
        out[f"{kb}KB"] = row
    return out


def _half_sm(hw: int, c: int, elem: int, k: int):
    """k blocks an image that leave room for a second block on their SM."""
    return kin._cluster_candidate(hw, c, elem, k, spread=False, full=False, cap=HALF_SM,
                                  stage_bytes=16 * 1024, slots=4)


def _candidates(b: int, hw: int, c: int, elem: int) -> dict:
    out = {"plan": kin.instance_norm_plan_for(torch.empty((b, hw, c), device="cuda",
                                                          dtype=torch.float32 if elem == 4
                                                          else torch.bfloat16)),
           "split": kin.SPLIT}
    for k in KS:
        p = kin._cluster_candidate(hw, c, elem, k, spread=True, full=True)
        if p is not None:
            out[f"k{k}_full"] = p
        for stage, slots in RINGS:
            p = kin._cluster_candidate(hw, c, elem, k, spread=True, full=False,
                                       stage_bytes=stage, slots=slots)
            if p is not None and p.slots:
                out[f"k{k}_ring{stage // 1024}x{slots}"] = p
        p = _half_sm(hw, c, elem, k)
        if p is not None:
            out[f"k{k}_half_sm"] = p
    return out


def _phase_library(tmp: str) -> ctypes.CDLL:
    """The source built with its phase marks on."""
    path = os.path.join(tmp, "libhst_instance_norm_marks.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-DIN_PHASE_TRACE", "-o", path, kin.LIBRARY.source],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path)
    kin._bind(lib)
    lib.hst_instance_norm_phase_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.hst_instance_norm_phase_marks.restype = ctypes.c_int
    return lib


def _phases(lib: ctypes.CDLL, gen) -> list:
    """Phase marks of the plan's launch, and of k = 14 and 16 blocks small
    enough to share an SM, at each shape."""
    out = []
    for (b, h, w, c) in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, h * w, c), device="cuda", generator=gen).to(dtype)
            scale = torch.ones((b, c), device="cuda")
            bias = torch.zeros((b, c), device="cuda")
            y = torch.empty_like(x)
            plans = {"plan": kin.instance_norm_plan_for(x),
                     "k14_half_sm": _half_sm(h * w, c, x.element_size(), 14),
                     "k16_half_sm": _half_sm(h * w, c, x.element_size(), 16)}
            for name, plan in plans.items():
                if plan is None or plan.route != "cluster":
                    continue
                for _ in range(3):  # the last launch's marks are read
                    kin._launch(lib, x, scale, bias, y, plan, kin.EPS, True)
                torch.cuda.synchronize()
                n = b * plan.k * MARKS
                clocks = torch.zeros(n, dtype=torch.int64)
                times = torch.zeros(n, dtype=torch.int64)
                kin.check("phase marks", lib.hst_instance_norm_phase_marks(
                    clocks.data_ptr(), times.data_ptr(), n))
                sms = len(set(clocks.view(-1, MARKS)[:, 7].tolist()))
                clocks = clocks.view(-1, MARKS)[:, :7].double()
                times = times.view(-1, MARKS)[:, :7].double()
                start = times[:, 0].min()
                row = dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1], config=name,
                           plan=plan._asdict(), distinct_sms=sms,
                           start_spread_ns=(times[:, 0].max() - start).item(),
                           last_mark_ns=(times[:, 6].max() - start).item(),
                           ns_mean=(times - times[:, :1]).mean(0).tolist(),
                           ns_max=(times - times[:, :1]).max(0).values.tolist(),
                           cycles_mean=(clocks - clocks[:, :1]).mean(0).tolist())
                out.append(row)
                print(f"[phases] {row['dtype']} {(b, h, w, c)} {name} k={plan.k} "
                      f"res={plan.res_rows} on {sms} SMs: start spread "
                      f"{row['start_spread_ns']:.0f} ns, last mark {row['last_mark_ns']:.0f} ns; "
                      f"marks 1..6 from the block's start, mean ns "
                      f"{[round(v) for v in row['ns_mean'][1:]]}, max ns "
                      f"{[round(v) for v in row['ns_max'][1:]]}", flush=True)
            del x, y
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("instance_norm_sweep needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    occ = _occupancy_table()
    for kb, row in occ.items():
        print(f"[occupancy] {kb:>6} a block, k = 1..16: {row}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    lib = kin.LIBRARY.load()
    rows = []
    for (b, h, w, c) in SHAPES:
        hw = h * w
        for dtype in (torch.float32, torch.bfloat16):
            elem = torch.tensor([], dtype=dtype).element_size()
            x = ((torch.randn((b, hw, c), device="cuda", generator=gen) * 2 + 0.5)
                 + torch.randn((c,), device="cuda", generator=gen)).to(dtype)
            scale = torch.randn((b, c), device="cuda", generator=gen)
            bias = torch.randn((b, c), device="cuda", generator=gen)
            want = kin.instance_norm_fwd_plain(x, scale, bias, relu=True).float()
            bound = 2 * b * hw * c * elem / 3.35e12 * 1e3
            for name, plan in _candidates(b, hw, c, elem).items():
                got = torch.empty_like(x)
                kin._launch(lib, x, scale, bias, got, plan, kin.EPS, True)
                torch.cuda.synchronize()
                rel = ((got.float() - want).abs().max() / want.abs().max()).item()
                clusters = plan.clusters
                if plan.route == "cluster" and not clusters:
                    clusters = kin._occupancy(torch.cuda.current_device(), hw, c, elem, plan)
                share, reread = kin.plan_traffic(plan, b, hw, c, elem)
                ms = _time_ms(lambda: kin._launch(lib, x, scale, bias, got, plan, kin.EPS, True))
                row = dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1], config=name,
                           plan=plan._asdict(), clusters=clusters, resident_share=share,
                           reread_bytes=reread, rel_err=rel, ms=ms, bound_ms=bound,
                           of_bound=bound / ms)
                rows.append(row)
                print(f"[sweep] {row['dtype']} {(b, h, w, c)} {name:<18} k={plan.k:<2} "
                      f"res={plan.res_rows:<5} smem={plan.smem:<6} clusters={clusters:<3} "
                      f"resident={share:.3f} ms={ms:.4f} of_bound={bound / ms:.3f} "
                      f"rel_err={rel:.2e}", flush=True)
            del x, want
    with tempfile.TemporaryDirectory() as tmp:
        phases = _phases(_phase_library(tmp), gen)
    result = {"device": smi, "occupancy": occ, "rows": rows, "phases": phases}
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "instance_norm_sweep.json"), "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
