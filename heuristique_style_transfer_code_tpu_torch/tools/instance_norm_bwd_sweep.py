"""Launch configurations of ``instance_norm_bwd``'s cluster route, on one GPU.

    python -m heuristique_style_transfer_code_tpu_torch.tools.instance_norm_bwd_sweep

Prints, and writes to ``chiprun_out/instance_norm_bwd_sweep.json`` when that
directory exists:

  shapes  at the family-3 style loop's b1 shapes and the fast-style net's
          (8,56,56,128) and (8,112,112,64), f32 and bf16, with ReLU (and
          at the net's without it), on signed inputs and unit affine rows:
          the plan's choice, the split route, and the cluster route at
          every group width g of 32, 64 or 128 bytes and cluster size k
          whose clusters are all resident at once; each held
          against the plain version (max error of dx relative to max|plain
          dx|) and timed by CUDA-graph replay, beside the library call
          (autograd through ``F.instance_norm`` and a ReLU, less its
          forward);
  phases  at the b1 shapes, the plan's launch and that of 32-byte groups
          with the smallest k that gives 128 blocks, from a build of the
          source with -DIN_PHASE_TRACE: per block, the time from its start
          to each phase mark of in_bwd_cluster_kernel (1 strips landed and
          summed, 2 their block sum, 3 the second pass and its block sum,
          4 the exchange, 5 the merge, 6 the apply issued), mean and max
          over the blocks in ns of
          %globaltimer, the spread of the blocks' starts and the SMs they
          ran on.

It measures the choices ``_bwd_plan`` makes; it is not part of the port's path.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch
import torch.nn.functional as F

from ..ops.kernels import instance_norm as kin
from .instance_norm_sweep import MARKS, _phase_library, _time_ms

B1_SHAPES = [(1, 112, 112, 64), (1, 56, 56, 128), (1, 55, 55, 256), (1, 28, 28, 256),
             (1, 14, 14, 512), (1, 13, 13, 1024)]
NET_SHAPES = [(8, 56, 56, 128), (8, 112, 112, 64)]


def _library_ms(x, dy, relu: bool, h: int, w: int) -> float:
    b, _, c = x.shape
    x4 = x.view(b, h, w, c).permute(0, 3, 1, 2).detach().requires_grad_(True)
    dy4 = dy.view(b, h, w, c).permute(0, 3, 1, 2)
    s0 = torch.ones((c,), device=x.device, requires_grad=True)
    b0 = torch.zeros((c,), device=x.device, requires_grad=True)

    def fwd():
        out = F.instance_norm(x4, weight=s0, bias=b0, eps=kin.EPS)
        return torch.relu(out) if relu else out

    return (_time_ms(lambda: torch.autograd.grad(fwd(), (x4, s0, b0), dy4))
            - _time_ms(fwd))


def _candidates(b: int, hw: int, c: int, elem: int, relu: bool, dev: int) -> list:
    v = 16 // elem
    out = []
    for g in (2 * v, 4 * v, 8 * v):
        groups = -(-c // g)
        for k in kin._BWD_CLUSTER_SIZES:
            if k > hw:
                break
            plan = kin.BwdPlan("cluster", g, k, kin._bwd_smem(hw, g, k, elem, relu))
            if plan.smem > kin._MAX_SMEM:
                continue
            plan = plan._replace(clusters=kin._bwd_occupancy(dev, hw, c, elem, relu, plan))
            if plan.clusters >= b * groups:
                out.append(plan)
    return out


def _wide_plan(b: int, hw: int, c: int, elem: int, relu: bool) -> kin.BwdPlan:
    """32-byte groups and the smallest k that gives 128 blocks (or 16)."""
    g = 32 // elem
    k = next((k for k in kin._BWD_CLUSTER_SIZES if b * -(-c // g) * k >= 128), 16)
    return kin.BwdPlan("cluster", g, k, kin._bwd_smem(hw, g, k, elem, relu))


def _phases(lib: ctypes.CDLL, gen) -> list:
    out = []
    for (b, h, w, c) in B1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            hw = h * w
            x = torch.randn((b, hw, c), device="cuda", generator=gen).to(dtype)
            dy = torch.randn((b, hw, c), device="cuda", generator=gen).to(dtype)
            scale = torch.ones((b, c), device="cuda")
            y = kin.instance_norm_fwd(x, scale, torch.zeros_like(scale), relu=True)
            dx, ds, db = torch.empty_like(x), torch.empty_like(scale), torch.empty_like(scale)
            plans = {"plan": kin.instance_norm_bwd_plan_for(x, True, dy, y),
                     "wide": _wide_plan(b, hw, c, x.element_size(), True)}
            for name, plan in plans.items():
                for _ in range(3):  # the last launch's marks are read
                    kin.check("instance_norm_bwd", lib.hst_instance_norm_bwd_cluster(
                        x.data_ptr(), dy.data_ptr(), y.data_ptr(), scale.data_ptr(),
                        dx.data_ptr(), ds.data_ptr(), db.data_ptr(), b, hw, c, plan.g, plan.k,
                        kin.EPS, 1, kin._DTYPE_CODE[dtype],
                        torch.cuda.current_stream().cuda_stream))
                torch.cuda.synchronize()
                n = -(-c // plan.g) * plan.k * MARKS
                clocks = torch.zeros(n, dtype=torch.int64)
                times = torch.zeros(n, dtype=torch.int64)
                kin.check("phase marks", lib.hst_instance_norm_phase_marks(
                    clocks.data_ptr(), times.data_ptr(), n))
                sms = len(set(clocks.view(-1, MARKS)[:, 7].tolist()))
                times = times.view(-1, MARKS)[:, :7].double()
                start = times[:, 0].min()
                row = dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1], config=name,
                           plan=plan._asdict(), distinct_sms=sms,
                           start_spread_ns=(times[:, 0].max() - start).item(),
                           last_mark_ns=(times[:, 6].max() - start).item(),
                           ns_mean=(times - times[:, :1]).mean(0).tolist(),
                           ns_max=(times - times[:, :1]).max(0).values.tolist())
                out.append(row)
                print(f"[phases] {row['dtype']} {(b, h, w, c)} {name} g={plan.g} k={plan.k} "
                      f"blocks={n // MARKS} on {sms} SMs: start spread "
                      f"{row['start_spread_ns']:.0f} ns, last mark {row['last_mark_ns']:.0f} ns; "
                      f"marks 1..6 from the block's start, mean ns "
                      f"{[round(v) for v in row['ns_mean'][1:]]}, max ns "
                      f"{[round(v) for v in row['ns_max'][1:]]}", flush=True)
            del x, dy, y, dx
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("instance_norm_bwd_sweep needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    cases = [(s, dt, True) for s in B1_SHAPES + NET_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(s, dt, False) for s in NET_SHAPES for dt in (torch.float32, torch.bfloat16)]
    for (b, h, w, c), dtype, relu in cases:
        hw = h * w
        x = (torch.randn((b, hw, c), device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        dy = torch.randn((b, hw, c), device="cuda", generator=gen).to(dtype)
        scale = torch.ones((b, c), device="cuda")
        bias = torch.zeros((b, c), device="cuda")
        y = kin.instance_norm_fwd(x, scale, bias, relu=True) if relu else None
        want = kin.instance_norm_bwd_plain(x, dy, scale, bias, relu=relu, y=y)[0].double()
        chosen = kin.instance_norm_bwd_plan_for(x, relu, dy, y)
        row = dict(shape=[b, h, w, c], dtype=str(dtype).split(".")[1], relu=relu,
                   plan=chosen._asdict(), library_ms=_library_ms(x, dy, relu, h, w), configs=[])
        for plan in [kin.BWD_SPLIT] + _candidates(b, hw, c, x.element_size(), relu, dev):
            got = kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y, _plan=plan)[0]
            torch.cuda.synchronize()
            err = ((got.double() - want).abs().max() / want.abs().max()).item()
            ms = _time_ms(lambda: kin.instance_norm_bwd(x, dy, scale, bias, relu=relu, y=y,
                                                        _plan=plan))
            groups = -(-c // plan.g) if plan.g else 0
            row["configs"].append(dict(plan=plan._asdict(), blocks=b * groups * plan.k,
                                       rel_err=err, ms=ms))
            print(f"{row['dtype']} {(b, h, w, c)} relu={relu} {plan.route} g={plan.g} "
                  f"k={plan.k} smem={plan.smem} clusters={plan.clusters} "
                  f"blocks={b * groups * plan.k}: ms={ms:.5f} rel_err={err:.2e}"
                  + ("  <- plan" if plan == chosen else ""))
        print(f"  library_ms={row['library_ms']:.5f}", flush=True)
        rows.append(row)
        del x, dy, y, want
    with tempfile.TemporaryDirectory() as tmp:
        phases = _phases(_phase_library(tmp), gen)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "instance_norm_bwd_sweep.json"), "w") as f:
            json.dump({"device": smi, "rows": rows, "phases": phases}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
