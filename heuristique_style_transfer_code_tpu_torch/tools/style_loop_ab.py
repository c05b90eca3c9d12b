"""The family-3 style loop and the kernels' host cost a call, at
``chip_smoke.py``'s settings, for comparing two trees on one card.

Run from the root of each tree in turn, in one call to the card (parent,
change, change, parent; copy this file into a tree that lacks it):

    python3 -m heuristique_style_transfer_code_tpu_torch.tools.style_loop_ab --label change

It prints one JSON line: image-iterations/s of ``style_transfer_patches``
(the family-3 test model at the config defaults, b1, 2 images x 20
iterations, threshold 0) at norm "batch" in f32 and bf16 and at norm
"instance" in f32, ``--rounds`` times each, and the host microseconds of a
call of ``GramFunction.apply`` at (1,4,4,64) and ``InstanceNormFunction.apply``
at (1,112,112,64) with ReLU: under ``no_grad``, under ``inference_mode``,
forward and backward, beside the direct ``gram_fwd`` wrapper.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

IMAGES, ITERS = 2, 20  # chip_smoke.py's F3_STYLE_IMAGES, F3_STYLE_ITERS


def _us(fn, calls: int) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _host_costs(kg, kin) -> dict:
    import torch

    f = torch.rand((1, 16, 64), device="cuda")
    fg = f.clone().requires_grad_(True)
    x = torch.randn((1, 112 * 112, 64), device="cuda")
    xg = x.clone().requires_grad_(True)
    one, zero = torch.ones((1, 64), device="cuda"), torch.zeros((1, 64), device="cuda")

    def gram_grad():
        g = kg.GramFunction.apply(fg)
        torch.autograd.grad(g, fg, g)

    def norm_grad():
        y = kin.InstanceNormFunction.apply(xg, one, zero, kin.EPS, True)
        torch.autograd.grad(y, xg, y)

    out = {"gram_fwd_wrapper_us": _us(lambda: kg.gram_fwd(f), 2000)}
    with torch.no_grad():
        out["gram_fwd_no_grad_us"] = _us(lambda: kg.GramFunction.apply(f), 2000)
        out["instance_norm_fwd_no_grad_us"] = _us(
            lambda: kin.InstanceNormFunction.apply(x, one, zero, kin.EPS, True), 2000)
    with torch.inference_mode():
        out["gram_fwd_inference_us"] = _us(lambda: kg.GramFunction.apply(f), 2000)
    out["gram_fwd_bwd_us"] = _us(gram_grad, 1000)
    out["instance_norm_fwd_bwd_us"] = _us(norm_grad, 500)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="tree")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import numpy as np
    import torch

    from ..checkpoint.convert import to_jax_tree
    from ..checkpoint.io import save_pytree_npz
    from ..cli._common import load_multi_patchgan
    from ..config.schema import MultiPatchGANConfig
    from ..core.device import resolve_device
    from ..models.multi_patchgan import multiscale_test_init
    from ..ops import kernels
    from ..ops.kernels import gram as kg
    from ..ops.kernels import instance_norm as kin
    from ..tasks.style_transfer import style_transfer_patches

    resolve_device("cuda")
    kernels.build_all()
    out = {"label": args.label, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0), **_host_costs(kg, kin)}
    rng = np.random.RandomState(17)
    batches = [{"image": rng.randint(0, 256, (1, 256, 256, 3)).astype(np.uint8),
                "label": np.zeros((1,), np.int32), "indices": np.arange(i, i + 1),
                "n_valid": 1} for i in range(IMAGES)]
    with tempfile.TemporaryDirectory(prefix="style_loop_ab_") as tmp:
        models = {}
        for norm in ("batch", "instance"):
            cfg = MultiPatchGANConfig(norm=norm)
            seeded = multiscale_test_init(
                torch.Generator().manual_seed(13), cfg.patch_sizes, ndf=cfg.ndf,
                num_classes=cfg.num_classes, gram_matrix_dim=cfg.gram_matrix_dim, norm=norm,
                device="cpu")
            ckpt = os.path.join(tmp, f"family3_{norm}.npz")
            save_pytree_npz(to_jax_tree(seeded), ckpt)
            models[norm] = (load_multi_patchgan(ckpt, cfg, torch.device("cuda")), cfg)
        for _ in range(args.rounds):
            for norm, dtype in (("batch", torch.float32), ("batch", torch.bfloat16),
                                ("instance", torch.float32)):
                model, cfg = models[norm]
                compute = None if dtype == torch.float32 else dtype
                key = f"{norm}_{str(dtype).split('.')[1]}_image_iterations_per_s"
                run = dict(gram_matrix_dim=cfg.gram_matrix_dim, norm=norm, threshold=0.0,
                           compute_dtype=compute, log_fn=lambda msg: None)
                style_transfer_patches(model, batches[:1], os.path.join(tmp, "warm"),
                                       num_iterations=2, **run)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                style_transfer_patches(model, batches, os.path.join(tmp, key),
                                       num_iterations=ITERS,
                                       generator=torch.Generator().manual_seed(18), **run)
                torch.cuda.synchronize()
                out.setdefault(key, []).append(IMAGES * ITERS / (time.perf_counter() - t0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
