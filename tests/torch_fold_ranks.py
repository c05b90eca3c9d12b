"""Rank bodies of ``tests/test_torch_fold_ranks.py``: ``--parallel_folds``
over a (fold, data) mesh of gloo ranks on the CPU, run by four spawned
ranks and, with no mesh, by the test process as the one-device reference.
This module imports no jax (a spawned rank imports it, not the test
module).

The cases read their inputs (JAX-layout weight trees, staged uint8
batches, labels) from one npz the test writes and return numpy arrays;
``run_kfold`` and the train CLI write their files under the output
directory, rank 0's standard output beside them.
"""
from __future__ import annotations

import contextlib
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
from heuristique_style_transfer_code_tpu_torch.config.schema import (
    GramAttentionConfig,
    MultiPatchGANConfig,
)
from heuristique_style_transfer_code_tpu_torch.core.mesh import FoldMesh, Mesh, create_mesh
from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
from heuristique_style_transfer_code_tpu_torch.ops import norm
from heuristique_style_transfer_code_tpu_torch.parallel import foldparallel as fp
from heuristique_style_transfer_code_tpu_torch.train import factories
from heuristique_style_transfer_code_tpu_torch.train.kfold import run_kfold
from heuristique_style_transfer_code_tpu_torch.train.mixing import make_mix_fn

WORLD, B, STAGE, CROP, LR, STEPS = 4, 8, 40, 32, 0.01, 2
F2_CFG = GramAttentionConfig(batch_size=B, lr=LR, truncate_layer=5, gram_matrix_size=4)
F3_PATCHES = {"small": 8, "medium": 6, "large": 6}
F3_CFG = MultiPatchGANConfig(batch_size=B, lr=LR, ndf=8, patch_sizes=F3_PATCHES, norm="batch")
MIXUP = 0.4
# run_kfold and the CLI: family 3 (norm "batch") at the CLI's 224² crop
KF_PATCHES = {"small": 10, "medium": 20, "large": 10}
KF_SAMPLES, KF_BATCH = 21, 2  # train folds of 10 and 11: 5 and 6 batches
CLI_CFG = {"batch_size": 4, "lr": 0.01, "ndf": 8, "patch_sizes": KF_PATCHES, "norm": "batch",
           "seed": 0}


def _augment(dtype):
    aug = make_augment_fn([(None, None)], crop=CROP)
    return lambda u8, combos, draws: aug(u8, combos, draws).to(dtype)


def _setup(family: str, dtype: torch.dtype, mix: bool):
    compute = dtype if dtype != torch.float32 else None
    mix_fn = make_mix_fn(mixup_alpha=MIXUP) if mix else None
    if family == "f2":
        return factories.setup_gram_attention(F2_CFG, 4, [(None, None)], device="cpu",
                                              compute_dtype=compute, mix_fn=mix_fn)
    return factories.setup_multi_patchgan(F3_CFG, 4, [(None, None)], device="cpu",
                                          compute_dtype=compute, mix_fn=mix_fn)


def fold_steps(fold_mesh, inputs, family: str, k_folds: int, active, dtype="float64",
               mix=False, steps=1):
    """``steps`` fold-parallel steps of ``family`` (f2: from the inputs'
    JAX trees ``f2_fold<k>``; f3, norm "batch": from seeded inits) on this
    rank's folds and rows (all of them without a ``fold_mesh``), each fold
    k's batch i ``images[i, k]``; then every fold's state shared. Returns
    this rank's local losses (steps, K/F), every fold's tree, trace and
    update count."""
    dt = getattr(torch, dtype)
    setup = _setup(family, dt, mix)
    states = []
    for k in range(k_folds):
        if family == "f2":
            model, _ = setup.init(None)
            load_jax_tree(model, inputs[f"f2_fold{k}"])
        else:
            model, _ = setup.init(torch.Generator().manual_seed(50 + k))
        model.to(dt)
        states.append((model, setup.optimizer[0](model)))
    local = list(fold_mesh.folds()) if fold_mesh is not None else list(range(k_folds))
    axis = fold_mesh.data_axis if fold_mesh is not None else None
    rows = axis.rows(B) if axis is not None and axis.world_size > 1 else np.arange(B)
    step = fp.make_foldwise_train_step(setup._forward_train, setup.optimizer, _augment(dt),
                                       mix_fn=setup.mix_fn, mesh=axis)
    stacked = fp.stack_fold_states([states[k] for k in local])
    losses = []
    for i in range(steps):
        batches = [{"image": inputs["images"][i, k][rows], "label": inputs["labels"][i, k][rows],
                    "mix_key": (0, k, 0, i)} for k in local]
        losses.append(step(stacked, batches, [bool(active[k]) for k in local]).tolist())
    fp.unstack_fold_state(stacked, [states[k] for k in local])
    if fold_mesh is not None:
        fp.broadcast_fold_states(fold_mesh, states)
    return {"loss": np.asarray(losses, np.float64),
            "folds": [to_jax_tree(m) for m, _ in states],
            "trace": [to_jax_tree(m, o["trace"]) for m, o in states],
            "count": np.asarray([o["count"] for _, o in states], np.int64)}


class CollectiveLog:
    """Within the block: the element count of every all-reduce and the
    calls of the global batch norm's vmap rules (forward, backward)."""

    def __enter__(self):
        self.all_reduce, self.bn_fwd, self.bn_bwd = [], [0], [0]
        self._saved = (Mesh._flat_all_reduce, norm.GlobalBatchNorm.vmap,
                       norm.GlobalBatchNormGrad.vmap)
        flat, fwd, bwd = self._saved

        def flat_all_reduce(mesh, t, op):
            self.all_reduce.append(t.numel())
            return flat(mesh, t, op)

        def counted(fn, box):
            def rule(*args):
                box[0] += 1
                return fn(*args)
            return staticmethod(rule)

        Mesh._flat_all_reduce = flat_all_reduce
        norm.GlobalBatchNorm.vmap = counted(fwd, self.bn_fwd)
        norm.GlobalBatchNormGrad.vmap = counted(bwd, self.bn_bwd)
        return self

    def __exit__(self, *exc):
        flat, fwd, bwd = self._saved
        Mesh._flat_all_reduce = flat
        norm.GlobalBatchNorm.vmap = staticmethod(fwd)
        norm.GlobalBatchNormGrad.vmap = staticmethod(bwd)


def mix_case(fold_mesh, inputs):
    """Family 3 (batch norms) under mixup, 3 folds on a 1 x 4 mesh (every
    rank vmaps all three on its 2 rows): two float64 steps, their
    collectives logged."""
    if fold_mesh is None:
        return fold_steps(None, inputs, "f3", 3, [True] * 3, mix=True, steps=STEPS)
    with CollectiveLog() as log:
        out = fold_steps(fold_mesh, inputs, "f3", 3, [True] * 3, mix=True, steps=STEPS)
    out["all_reduce"] = np.asarray(log.all_reduce, np.int64)
    out["bn_vmap"] = np.asarray([log.bn_fwd[0], log.bn_bwd[0]], np.int64)
    return out


def kfold_setup(batch_size: int):
    cfg = MultiPatchGANConfig(batch_size=batch_size, lr=0.05, ndf=8, patch_sizes=KF_PATCHES,
                              norm="batch")
    setup = factories.setup_multi_patchgan(cfg, 4, [(None, None)], device="cpu",
                                           compute_dtype=torch.float64, clip_norm=0.5,
                                           ema_decay=0.9)

    def init_fn(fold):
        model, _ = setup.init(torch.Generator().manual_seed(fold))
        model = model.double()
        return model, setup.optimizer[0](model), setup.train_step, setup.eval_step

    return setup, init_fn


def kfold_case(fold_mesh, data_root: str, save_dir: str):
    """``run_kfold`` of family 3 in float64 over 2 folds at b2 (the fold
    mesh 2 x 2, each rank one row of its fold's batches; evaluation on the
    first 2 ranks)."""
    dataset = ImageFolderIndex(os.path.join(data_root, "train"))
    dataset.samples = dataset.samples[:KF_SAMPLES]
    setup, init_fn = kfold_setup(KF_BATCH)
    run_kfold(dataset, k_folds=2, seed=0, epochs=1, batch_size=KF_BATCH, save_dir=save_dir,
              hyperparameters={"lr": 0.05}, init_fn=init_fn, eval_variables_fn=lambda m, o: m,
              foldwise_step=setup.foldwise_step(
                  fold_mesh.data_axis if fold_mesh is not None else None),
              fold_mesh=fold_mesh)


def cli_argv(data_root: str, cfg_path: str, save_dir: str, devices: int) -> list:
    return ["--data", data_root, "--config_path", cfg_path, "--k_folds", "2", "--epochs", "1",
            "--save_dir", save_dir, "--device", "cpu", "--parallel_folds",
            "--devices", str(devices)]


def rank_main(rank: int, world: int, init_method: str, in_dir: str, out_dir: str,
              data_root: str) -> None:
    """A spawned gloo rank: the cases on their fold meshes (results in
    ``out_dir/rank<r>.npz``, each case's seconds with them), then
    ``run_kfold`` and the family-3 CLI (``--devices 4``), joining the
    group as under ``torchrun``; rank 0's standard output in
    ``out_dir/rank0_kfold.txt`` and ``out_dir/rank0_cli.txt``."""
    from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import main
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    initialize_distributed(rank, world, init_method, backend="gloo")
    try:
        mesh = create_mesh(world)
        inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))
        results, seconds = {}, {}
        t0 = time.perf_counter()
        step22 = FoldMesh(mesh, 2, 2, 2, world)
        for dtype in ("float32", "float64"):
            results[f"step22_{dtype}"] = fold_steps(step22, inputs, "f2", 2, [True, False],
                                                    dtype=dtype)
        seconds["step22"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results["mix14"] = mix_case(FoldMesh(mesh, 3, 1, 4, world), inputs)
        seconds["mix14"] = time.perf_counter() - t0
        results["seconds"] = seconds

        def logged(name, fn):
            t0 = time.perf_counter()
            sink = (open(os.path.join(out_dir, f"rank0_{name}.txt"), "w") if rank == 0
                    else open(os.devnull, "w"))
            with sink, contextlib.redirect_stdout(sink):
                fn()
            seconds[name] = time.perf_counter() - t0

        logged("kfold", lambda: kfold_case(FoldMesh(mesh, 2, 2, 2, 2), data_root,
                                           os.path.join(out_dir, "kfold")))
        # the CLI joins this group, as under torchrun (its own checks, mesh and files)
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                           "LOCAL_RANK": str(rank)})
        logged("cli", lambda: main(cli_argv(data_root, os.path.join(in_dir, "cli.json"),
                                            os.path.join(out_dir, "cli"), world)))
        save_pytree_npz(results, os.path.join(out_dir, f"rank{rank}.npz"))
    finally:
        shutdown_distributed()
