"""Family-2 training assembly (``train/factories.py`` of the JAX package:
``_setup`` ``:101-141`` and ``setup_gram_attention`` ``:225-275``): a
fresh model per fold (with the pretrained tree loaded shape by shape), the
SGD optimiser with its trainability mask, and the train and eval steps.

``--freeze_layers`` freezes everything but ``classifier`` and ``attention``
(the reference's ``set_parameter_requires_grad``): those parameters get
``requires_grad=False`` and the optimiser's mask. The frozen encoder still
runs in train mode, so its batch-norm statistics update, as in JAX; its
Grams then need no gradient, so only ``pooled_gram_fwd`` launches.

``compute_dtype`` (``--precision bf16``) follows JAX ``_cast_inputs``
(``:35-44``; the port's ``cli/_common.cast_forward``): the images are cast
to it before the forward, so the activations run in bf16 while the
parameters stay f32 (each op casts its weights) and the loss is taken in
f32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..checkpoint.convert import load_jax_tree, to_jax_tree
from ..cli._common import cast_forward
from ..config.schema import GramAttentionConfig
from ..data.augment import make_augment_fn
from ..models.gram_attention import gram_attention_apply, gram_attention_init
from .optim import sgd_momentum
from .train_loop import make_eval_step, make_train_step_body


class FamilySetup:
    """The steps built once; ``init(generator)`` gives a fold's fresh
    ``(model, opt_state)``."""

    def __init__(self, init_model: Callable, optimizer, train_step: Callable,
                 eval_step: Callable):
        self._init_model = init_model
        self.optimizer = optimizer
        self.train_step = train_step
        self.eval_step = eval_step

    def init(self, generator: Optional[torch.Generator]):
        model = self._init_model(generator)
        return model, self.optimizer[0](model)


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
    device="cuda",
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
        if frozen_fn is not None:
            for name, p in model.named_parameters():
                p.requires_grad_(not frozen_fn(name))
        return model.train()

    def forward_train(model, images):
        model.train()
        _, logits = gram_attention_apply(model, images, t, s, num_classes)
        return logits

    def forward_eval(model, images):
        model.eval()
        _, logits = gram_attention_apply(model, images, t, s, num_classes)
        return logits

    optimizer = sgd_momentum(lr_schedule if lr_schedule is not None else config.lr,
                             frozen_fn=frozen_fn, clip_norm=clip_norm, ema_decay=ema_decay)
    augment = make_augment_fn(combos)
    train_step = make_train_step_body(cast_forward(forward_train, compute_dtype), optimizer,
                                      augment, label_smoothing)
    eval_step = make_eval_step(cast_forward(forward_eval, compute_dtype))
    return FamilySetup(init_model, optimizer, train_step, eval_step)
