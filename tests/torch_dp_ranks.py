"""Rank bodies of ``tests/test_torch_data_parallel.py``: the port's
data-parallel steps on the CPU, run by the spawned gloo ranks and, with no
mesh, by the test process as the one-device reference. This module imports
no jax (a spawned rank imports it, not the test module).

Every case reads its inputs (JAX-layout weight trees, staged uint8 batches,
labels) from one npz the test writes, runs ``STEPS`` train steps on this
rank's rows of each global batch and returns numpy arrays: the global
losses, the whole model tree and the whole optimiser state.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh
from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
from heuristique_style_transfer_code_tpu_torch.train.kfold import _inprogress_tree, _restore
from heuristique_style_transfer_code_tpu_torch.train.mixing import make_mix_fn, mix_draws
from heuristique_style_transfer_code_tpu_torch.train.optim import full_state, sgd_momentum
from heuristique_style_transfer_code_tpu_torch.train.train_loop import (
    make_train_step_accum,
    make_train_step_body,
)

B, STAGE, CROP, LR, STEPS = 8, 40, 32, 0.01, 2
F1_TRUNCATE, F1_DIM = 5, 16
F2_TRUNCATE, F2_S = 5, 4
F3_PATCHES = {"small": 8, "medium": 6, "large": 6}
STYLE_TRUNCATE, STYLE_LR = 6, 1e-3
MIXUP, CUTMIX = 0.4, 1.0
FAMILIES = ("f1", "f2", "f3")


def _mix_keys():
    """Two batch keys whose draws are mixup, then cutmix."""
    found = {}
    for k in range(1000):
        key = (0, 0, 0, k)
        cut = mix_draws(key, B, CROP, CROP, True, True, MIXUP, CUTMIX)[0]
        found.setdefault(cut, key)
        if len(found) == 2:
            return [found[False], found[True]]
    raise AssertionError("no mixup and cutmix keys")


MIX_KEYS = _mix_keys()


def port_model(family: str, tree, dtype=torch.float32):
    """The port's train-mode model of ``family`` from a JAX-layout tree."""
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
            truncated_resnet50_init,
        )

        model = truncated_resnet50_init(None, F1_TRUNCATE, 4, F1_DIM, device="cpu")
    elif family == "f2":
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_init,
        )

        model = gram_attention_init(None, F2_TRUNCATE, 4, F2_S, device="cpu")
    else:
        from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
            multiscale_init,
        )

        model = multiscale_init(None, F3_PATCHES, ndf=8, num_classes=4, norm="batch",
                                device="cpu")
    return load_jax_tree(model, tree).to(dtype).train()


def port_forward(family: str):
    if family == "f1":
        from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
            combined_apply,
        )

        return lambda m, x: combined_apply(m.moco, m.classifier, x, F1_TRUNCATE, train=True)
    if family == "f2":
        from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
            gram_attention_apply,
        )

        def forward(m, x):
            m.train()
            return gram_attention_apply(m, x, F2_TRUNCATE, F2_S, 4)[1]

        return forward
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import multiscale_apply

    return lambda m, x: multiscale_apply(m, x, "batch", train=True)


def _augment(dtype):
    aug = make_augment_fn([(None, None)], crop=CROP)
    return lambda u8, combos, draws: aug(u8, combos, draws).to(dtype)


def _local(mesh, x, n_accum=1):
    return x if mesh is None else mesh.local(x, n_accum)


def run_classifier(mesh, inputs, family, dtype="float32", zero1=False, ema=None, clip=None,
                   mix=False, n_accum=1, labels="labels", steps=STEPS, start=None,
                   save_after=None):
    """``steps`` steps of ``family`` (f1, f2, f3) from ``inputs[family]``
    (or from the in-progress file ``start``, which then gives the first
    step's index); ``save_after`` (a path) writes the in-progress tree after
    the first step (rank 0)."""
    dt = getattr(torch, dtype)
    model = port_model(family, inputs[family], dt)
    opt = sgd_momentum(LR, clip_norm=clip, ema_decay=ema, mesh=mesh, zero1=zero1)
    state = opt[0](model)
    first = 0
    if start is not None:
        st = load_pytree_npz(start)
        _restore(model, state, st)
        model.to(dt)
        first = int(np.asarray(st["epochs_done"]))
    mix_fn = make_mix_fn(MIXUP, CUTMIX) if mix else None
    if n_accum > 1:
        step = make_train_step_accum(port_forward(family), opt, _augment(dt), n_accum,
                                     mix_fn=mix_fn, mesh=mesh)
    else:
        step = make_train_step_body(port_forward(family), opt, _augment(dt), mix_fn=mix_fn,
                                    mesh=mesh)
    losses = []
    for i in range(first, steps):
        u8 = _local(mesh, inputs["images"][i], n_accum)
        lab = _local(mesh, inputs[labels][i], n_accum)
        model, state, loss = step(model, state, u8, lab, mix_key=MIX_KEYS[i])
        losses.append(float(loss))
        if save_after is not None and i == first:
            tree = _inprogress_tree(model, state, 0, i + 1, "dp-test")
            if mesh is None or mesh.is_main:
                save_pytree_npz(tree, save_after)
    out = {"loss": np.asarray(losses, np.float64), "params": to_jax_tree(model)}
    whole = full_state(state)
    out["opt"] = {part: to_jax_tree(model, whole[part]) for part in ("trace", "ema")
                  if part in whole}
    if "zero1" in state:
        layout = state["zero1"]
        split, repl = layout.state_bytes(state["trace"])
        total = sum(t.numel() * t.element_size() for t in whole["trace"].values())
        out["bytes"] = np.asarray([split, repl, total], np.int64)
    return out


def _style_setup(inputs):
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    encoder = load_jax_tree(gram_attention_init(None, STYLE_TRUNCATE, 4, 4, device="cpu"),
                            inputs["style_encoder"])
    return pst.make_extract_fn_gram_attention(encoder, STYLE_TRUNCATE, style_layers="all")


def run_style(mesh, inputs):
    """Two steps of the single-style net (``make_fast_style_train_step``)."""
    from heuristique_style_transfer_code_tpu_torch.tasks import fast_style as pf

    px = _style_setup(inputs)
    net = pf.net_from_tree(inputs["style_net"], "cpu")
    init, step = pf.make_fast_style_train_step(px, learning_rate=STYLE_LR, crop=CROP, mesh=mesh)
    grams = pf.encode_style_grams(px, inputs["style_image"], CROP, "cpu")
    state = init(net)
    losses = []
    for i in range(STEPS):
        net, state, loss = step(net, state, _local(mesh, inputs["images"][i]), grams)
        losses.append(float(loss))
    return {"loss": np.asarray(losses, np.float64), "params": to_jax_tree(net)}


def run_style_multi(mesh, inputs):
    """``train_multi_style`` over the two batches: each rank draws the
    global batch's styles and takes its rows."""
    from heuristique_style_transfer_code_tpu_torch.tasks import fast_style as pf

    px = _style_setup(inputs)
    net = pf.net_from_tree(inputs["style_cond"], "cpu")
    loader = [{"image": _local(mesh, inputs["images"][i])} for i in range(STEPS)]
    styles = [inputs["style_image"], inputs["style_image2"]]
    net, history = pf.train_multi_style(net, px, loader, styles, epochs=1,
                                        learning_rate=STYLE_LR, crop=CROP, mesh=mesh,
                                        log_fn=lambda s: None, log_every=1)
    return {"loss": np.asarray(history, np.float64), "params": to_jax_tree(net)}


CASES = {
    **{fam: (lambda fam: lambda mesh, inp: run_classifier(mesh, inp, fam))(fam)
       for fam in FAMILIES},
    **{f"{fam}_f64": (lambda fam: lambda mesh, inp: run_classifier(mesh, inp, fam, "float64"))(fam)
       for fam in FAMILIES},
    "mix": lambda mesh, inp: run_classifier(mesh, inp, "f2", mix=True),
    "pad": lambda mesh, inp: run_classifier(mesh, inp, "f1", labels="labels_pad"),
    "accum": lambda mesh, inp: run_classifier(mesh, inp, "f3", n_accum=2),
    "dp_ema_clip": lambda mesh, inp: run_classifier(mesh, inp, "f2", ema=0.9, clip=0.5),
    "zero1": lambda mesh, inp: run_classifier(mesh, inp, "f2", zero1=True, ema=0.9, clip=0.5,
                                              save_after=inp["_out"] + "/saved.npz"),
    "zero1_from_1": lambda mesh, inp: run_classifier(mesh, inp, "f2", zero1=True, ema=0.9,
                                                     clip=0.5,
                                                     start=inp["_in"] + "/saved.npz"),
    "style": run_style,
    "style_multi": run_style_multi,
}


def rank_main(rank: int, world: int, init_method: str, in_dir: str, out_dir: str,
              cases) -> None:
    """A spawned gloo rank: every case of ``cases`` on the CPU, its results
    in ``out_dir/rank<r>.npz``."""
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        mesh = create_mesh(world)
        inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))
        inputs.update(_in=in_dir, _out=out_dir)
        results = {}
        for case in cases:
            t0 = time.perf_counter()
            results[case] = CASES[case](mesh, inputs)
            results[case]["seconds"] = np.float64(time.perf_counter() - t0)
        save_pytree_npz(results, os.path.join(out_dir, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()


def failing_rank(rank: int, world: int, init_method: str) -> None:
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
    )

    initialize_distributed(rank, world, init_method, backend="gloo")
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    create_mesh(world).all_reduce([torch.ones(3)])
