"""The QAT fine-tune loop (``train/qat.py`` of the JAX package): a short
SGD-with-momentum fine-tune of a model through its fake-quant forward
(``nn/resnet_qat.py``), so the weights move to where the deploy-time int8
rounding stops hurting. The batch-norm running statistics stay frozen
(detached in the fold, and outside the optimiser), so the folded graph
the export ships is the one that was trained.

    scales = calibrate_activation_scales(encoder, cal_images, truncate)
    qat_finetune(model, forward_logits, batches, steps, lr)
    q = quantize_resnet50(model's encoder, scales, truncate)
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from .optim import sgd_momentum
from .train_loop import masked_cross_entropy


def qat_finetune(model: torch.nn.Module, forward_logits: Callable,
                 batches: List[Tuple[torch.Tensor, torch.Tensor]], steps: int,
                 lr: float = 1e-4, momentum: float = 0.9) -> torch.nn.Module:
    """``steps`` SGD-momentum steps of the masked cross-entropy of
    ``forward_logits(model, images)``, cycling through ``batches``
    ((normalised f32 NHWC images, int labels) pairs, pads -1), on
    ``model``'s parameters in place; prints JAX's line with the first and
    last losses and returns ``model``."""
    init, update = sgd_momentum(lr, momentum=momentum)
    opt_state = init(model)
    params = dict(model.named_parameters())
    names = list(opt_state["trace"])
    first = last = None
    for i in range(steps):
        images, labels = batches[i % len(batches)]
        with torch.enable_grad():
            loss = masked_cross_entropy(forward_logits(model, images), labels)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True, materialize_grads=True)
        update(model, dict(zip(names, grads)), opt_state)
        if first is None:
            first = loss.detach()
        last = loss.detach()
    if first is not None:
        print(f"QAT fine-tune: {steps} pas, perte {float(first):.4f} -> {float(last):.4f}")
    return model
