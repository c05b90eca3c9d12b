"""Training assembly of families 1, 2 and 3 (``train/factories.py`` of the
JAX package: ``_setup`` ``:101-141``, ``setup_truncated_resnet50``
``:144-206``, ``setup_gram_attention`` ``:225-275``,
``setup_multi_patchgan`` ``:295-338``): a fresh model per fold (with the
pretrained tree), the SGD optimiser with its trainability mask, the
augmentation of the run's transform combinations, and the train and eval
steps.

A frozen subtree (family 1's ``--freeze_encoder``: every ``moco`` path;
family 2's ``--freeze_layers``: everything but ``classifier`` and
``attention``, the reference's ``set_parameter_requires_grad``) gets
``requires_grad=False`` and the optimiser's mask. It still runs in train
mode, so its batch-norm statistics update, as in JAX; family 2's frozen
Grams then need no gradient, so only ``pooled_gram_fwd`` launches.

``compute_dtype`` (``--precision bf16``) follows JAX ``_cast_inputs``
(``:35-44``; the port's ``cli/_common.cast_forward``): the images are cast
to it before the forward, so the activations run in bf16 while the
parameters stay f32 (each op casts its weights) and the loss is taken in
f32. ``remat`` (``--remat``) checkpoints each bottleneck of the ResNet
encoders and each strided unit of the discriminators in the train
forward (``core/remat.py``); ``FamilySetup.accum_step`` is
``--grad_accum``'s step (JAX ``:88-99``). ``ema_decay`` (``--ema_decay``)
keeps the parameter EMA in the optimiser state (``train/optim.py``);
``mix_fn`` (``--mixup``/``--cutmix``, ``train/mixing.make_mix_fn``) mixes
each augmented batch in both steps. ``mesh`` (``--devices``, a
``core.mesh.Mesh``) makes both steps data-parallel (``train/train_loop.py``)
and ``zero1`` (``--zero1``) shards the optimiser state over it (JAX
``:101-140``); on one device neither changes anything.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..checkpoint.convert import load_jax_tree, to_jax_tree
from ..cli._common import cast_forward
from ..config.schema import GramAttentionConfig, MultiPatchGANConfig, TruncatedResNetConfig
from ..data.augment import make_augment_fn
from ..models.gram_attention import gram_attention_apply, gram_attention_init
from ..models.multi_patchgan import multiscale_apply, multiscale_init
from ..models.truncated_resnet50 import combined_apply, truncated_resnet50_init
from .optim import sgd_momentum
from .train_loop import make_eval_step, make_train_step_accum, make_train_step_body


class FamilySetup:
    """The steps built once; ``init(generator)`` gives a fold's fresh
    ``(model, opt_state)``; ``accum_step(n)`` the gradient-accumulation
    step and ``foldwise_step()`` the fold-parallel one over the same
    forward, optimiser and augmentation."""

    def __init__(self, init_model: Callable, optimizer, train_step: Callable,
                 eval_step: Callable, forward_train: Callable, augment: Callable,
                 label_smoothing: float = 0.0, mix_fn: Optional[Callable] = None,
                 mesh=None):
        self._init_model = init_model
        self.optimizer = optimizer
        self.train_step = train_step
        self.eval_step = eval_step
        self._forward_train = forward_train
        self._augment = augment
        self._label_smoothing = label_smoothing
        self.mix_fn = mix_fn
        self.mesh = mesh

    def init(self, generator: Optional[torch.Generator]):
        model = self._init_model(generator)
        return model, self.optimizer[0](model)

    def foldwise_step(self, mesh=None) -> Callable:
        """``--parallel_folds``: the step of every fold at once over the same
        forward, optimiser, augmentation and mixing
        (``parallel.foldparallel.make_foldwise_train_step``); ``mesh`` the
        data axis of this rank's fold group (``core.mesh.FoldMesh``)."""
        from ..parallel.foldparallel import make_foldwise_train_step

        return make_foldwise_train_step(self._forward_train, self.optimizer, self._augment,
                                        self._label_smoothing, self.mix_fn, mesh)

    def accum_step(self, n_accum: int) -> Callable:
        """``--grad_accum``: one optimiser update from ``n_accum``
        micro-batches (``train_loop.make_train_step_accum``)."""
        return make_train_step_accum(self._forward_train, self.optimizer, self._augment,
                                     n_accum, self._label_smoothing, self.mix_fn, self.mesh)


def _freeze(model, frozen_fn):
    if frozen_fn is not None:
        for name, p in model.named_parameters():
            p.requires_grad_(not frozen_fn(name))
    return model


def _assemble(init_model, forward, lr, combos, frozen_fn, compute_dtype, clip_norm,
              label_smoothing, ema_decay, mix_fn, mesh=None, zero1=False) -> FamilySetup:
    """``forward(model, images, train)`` -> logits; the JAX ``_setup``."""
    optimizer = sgd_momentum(lr, frozen_fn=frozen_fn, clip_norm=clip_norm, ema_decay=ema_decay,
                             mesh=mesh, zero1=zero1)
    forward_train = cast_forward(lambda m, x: forward(m, x, True), compute_dtype)
    augment = make_augment_fn(combos)
    train_step = make_train_step_body(forward_train, optimizer, augment, label_smoothing,
                                      mix_fn, mesh)
    eval_step = make_eval_step(cast_forward(lambda m, x: forward(m, x, False), compute_dtype))
    return FamilySetup(init_model, optimizer, train_step, eval_step, forward_train, augment,
                       label_smoothing, mix_fn, mesh)


def setup_truncated_resnet50(
    config: TruncatedResNetConfig,
    num_classes: int,
    combos: Sequence,
    pretrained: Optional[Dict] = None,
    freeze_encoder: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    lr_schedule=None,
    clip_norm: Optional[float] = None,
    label_smoothing: float = 0.0,
    ema_decay: Optional[float] = None,
    mix_fn: Optional[Callable] = None,
    remat: bool = False,
    device="cuda",
    mesh=None,
    zero1: bool = False,
) -> FamilySetup:
    """The family-1 setup on ``device``. ``pretrained``: a ``{moco,
    classifier}`` tree that each fold loads whole, or a ``{moco}`` one
    (the CLI dropped a classifier of the wrong shape) loaded beside the
    fold's fresh classifier; either must fit the configured truncation
    leaf for leaf."""
    t = config.truncate_layer
    frozen_fn = (lambda path: path.startswith("moco")) if freeze_encoder else None  # noqa: E731

    def init_model(generator):
        model = truncated_resnet50_init(generator, t, num_classes, config.dim, device=device)
        if pretrained is not None:
            if "classifier" in pretrained:
                load_jax_tree(model, pretrained)
            else:
                load_jax_tree(model.moco, pretrained["moco"])
        return _freeze(model, frozen_fn).train()

    def forward(model, images, train):
        return combined_apply(model.moco, model.classifier, images, t, train=train,
                              remat=remat and train)

    return _assemble(init_model, forward, lr_schedule if lr_schedule is not None else config.lr,
                     combos, frozen_fn, compute_dtype, clip_norm, label_smoothing, ema_decay,
                     mix_fn, mesh, zero1)


def setup_multi_patchgan(
    config: MultiPatchGANConfig,
    num_classes: int,
    combos: Sequence,
    pretrained: Optional[Dict] = None,
    compute_dtype: Optional[torch.dtype] = None,
    lr_schedule=None,
    clip_norm: Optional[float] = None,
    label_smoothing: float = 0.0,
    ema_decay: Optional[float] = None,
    mix_fn: Optional[Callable] = None,
    remat: bool = False,
    device="cuda",
    mesh=None,
    zero1: bool = False,
) -> FamilySetup:
    """The family-3 setup (the train variant) on ``device``. ``pretrained``:
    a JAX-layout tree whose same-path, same-shape leaves overwrite each
    fold's fresh init (``shape_filtered_update``). Under norm "instance"
    a step launches 13 ``instance_norm_fwd`` and 13 ``instance_norm_bwd``
    at the config defaults."""
    from ..checkpoint.pth_converter import shape_filtered_update

    norm = config.norm

    def init_model(generator):
        model = multiscale_init(generator, config.patch_sizes, ndf=config.ndf,
                                num_classes=num_classes, norm=norm, device=device)
        if pretrained is not None:
            load_jax_tree(model, shape_filtered_update(to_jax_tree(model), pretrained))
        return model.train()

    def forward(model, images, train):
        return multiscale_apply(model, images, norm, train=train, remat=remat and train)

    return _assemble(init_model, forward, lr_schedule if lr_schedule is not None else config.lr,
                     combos, None, compute_dtype, clip_norm, label_smoothing, ema_decay, mix_fn,
                     mesh, zero1)


def setup_gram_attention(
    config: GramAttentionConfig,
    num_classes: int,
    combos: Sequence,
    pretrained: Optional[Dict] = None,
    freeze_encoder: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    lr_schedule=None,
    clip_norm: Optional[float] = None,
    label_smoothing: float = 0.0,
    ema_decay: Optional[float] = None,
    mix_fn: Optional[Callable] = None,
    remat: bool = False,
    device="cuda",
    mesh=None,
    zero1: bool = False,
) -> FamilySetup:
    """The family-2 setup on ``device``. ``pretrained``: a JAX-layout tree
    whose same-path, same-shape leaves overwrite each fold's fresh init
    (``shape_filtered_update``); ``lr_schedule`` replaces the config's
    fixed rate."""
    from ..checkpoint.pth_converter import shape_filtered_update

    t, s = config.truncate_layer, config.gram_matrix_size
    frozen_fn = None
    if freeze_encoder:
        frozen_fn = lambda path: not path.startswith(("classifier", "attention"))  # noqa: E731

    def init_model(generator):
        model = gram_attention_init(generator, t, num_classes, s, device=device)
        if pretrained is not None:
            load_jax_tree(model, shape_filtered_update(to_jax_tree(model), pretrained))
        return _freeze(model, frozen_fn).train()

    def forward(model, images, train):
        model.train(train)
        _, logits = gram_attention_apply(model, images, t, s, num_classes,
                                         remat=remat and train)
        return logits

    return _assemble(init_model, forward, lr_schedule if lr_schedule is not None else config.lr,
                     combos, frozen_fn, compute_dtype, clip_norm, label_smoothing, ema_decay,
                     mix_fn, mesh, zero1)
