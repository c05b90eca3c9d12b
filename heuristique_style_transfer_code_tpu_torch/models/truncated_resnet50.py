"""Model family 1: the truncated MoCo encoder and the classifier
(``models/truncated_resnet50.py`` of the JAX package), eval and train.

    TruncatedMoCo      encoder (ResNet50 children [0:truncate]) -> global
                       average pool -> fc (feat -> dim)
    Classifier         fc (dim -> num_classes)
    TruncatedResNet50  {moco, classifier}, the JAX checkpoint's tree

Truncate <= 8 pools after the encoder; truncate 9 runs the avgpool child
inside it. In train mode (``train=True``, or the modules' ``.train()``)
the encoder's batch norms take the batch's statistics and update their
running buffers in place: the JAX train forward (``:48-84``) with its new
encoder tree merged back. ``combined_apply_int8`` runs the post-training
quantised encoder (``nn/resnet_int8.py``) under the float heads,
``combined_apply_qat`` its fake-quant twin (``nn/resnet_qat.py``, JAX
``:87-115``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.resnet import ResNet50Encoder, resnet50_apply, truncated_feature_channels
from ..ops.linear import Linear
from ..ops.pooling import global_avg_pool


class TruncatedMoCo(nn.Module):
    def __init__(self, truncate_layer: int, dim: int = 256,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.truncate = truncate_layer
        self.encoder = ResNet50Encoder(min(truncate_layer, 9), generator, device, dtype)
        self.fc = Linear(truncated_feature_channels(truncate_layer), dim, generator, device,
                         dtype)

    def forward(self, x):
        return truncated_moco_apply(self, x, self.truncate)


class Classifier(nn.Module):
    def __init__(self, input_dim: int, num_classes: int,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.fc = Linear(input_dim, num_classes, generator, device, dtype)

    def forward(self, x):
        return classifier_apply(self, x)


class TruncatedResNet50(nn.Module):
    """The combined model; its state dict is the JAX ``{moco, classifier}``
    tree renamed (``checkpoint/convert.py``)."""

    def __init__(self, truncate_layer: int, num_classes: int, dim: int = 256,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.truncate = truncate_layer
        self.moco = TruncatedMoCo(truncate_layer, dim, generator, device, dtype)
        self.classifier = Classifier(dim, num_classes, generator, device, dtype)

    def forward(self, x):
        return combined_apply(self.moco, self.classifier, x, self.truncate)


def truncated_moco_init(generator: Optional[torch.Generator], truncate_layer: int,
                        dim: int = 256, device="cuda", dtype=torch.float32) -> TruncatedMoCo:
    """The MoCo encoder in eval mode on ``device`` (``cuda`` unless the
    caller asks for ``cpu``), its random weights drawn from ``generator``
    (a CPU ``torch.Generator``; None = the global one)."""
    return TruncatedMoCo(truncate_layer, dim, generator, resolve_device(device), dtype).eval()


def classifier_init(generator: Optional[torch.Generator], input_dim: int, num_classes: int,
                    device="cuda", dtype=torch.float32) -> Classifier:
    return Classifier(input_dim, num_classes, generator, resolve_device(device), dtype).eval()


def truncated_resnet50_init(generator: Optional[torch.Generator], truncate_layer: int,
                            num_classes: int, dim: int = 256, device="cuda",
                            dtype=torch.float32) -> TruncatedResNet50:
    return TruncatedResNet50(truncate_layer, num_classes, dim, generator,
                             resolve_device(device), dtype).eval()


def truncated_moco_apply(moco: TruncatedMoCo, x: torch.Tensor, truncate: int,
                         remat: bool = False) -> torch.Tensor:
    """x: (N, H, W, 3) NHWC -> embeddings (N, dim), in the module's mode;
    ``remat`` checkpoints each bottleneck."""
    feats, _ = resnet50_apply(moco.encoder, x, truncate=min(truncate, 9), remat=remat)
    if truncate <= 8:
        feats = global_avg_pool(feats)
    return moco.fc(feats)


def classifier_apply(classifier: Classifier, x: torch.Tensor) -> torch.Tensor:
    return classifier.fc(x)


def combined_apply(moco: TruncatedMoCo, classifier: Classifier, x: torch.Tensor,
                   truncate: int, train: Optional[bool] = None,
                   remat: bool = False) -> torch.Tensor:
    """x: (N, H, W, 3) -> logits (N, num_classes). ``train`` sets the
    encoder's mode first (its batch norms'); None keeps it. ``remat``
    checkpoints each bottleneck (JAX ``:53-80``)."""
    if train is not None:
        moco.train(train)
    return classifier_apply(classifier, truncated_moco_apply(moco, x, truncate, remat))


def prepare_combined_int8(moco: TruncatedMoCo, truncate: int, calibration_batches):
    """PTQ of the MoCo encoder (truncate in [4, 8]); the average pool, the
    MoCo fc and the classifier stay float. Returns the quantised encoder
    for ``combined_apply_int8``."""
    from ..nn.resnet_int8 import prepare_int8_resnet

    return prepare_int8_resnet(moco.encoder, calibration_batches, truncate)


def combined_apply_qat(moco: TruncatedMoCo, classifier: Classifier, act_scales,
                       x: torch.Tensor, truncate: int) -> torch.Tensor:
    """The QAT fine-tune forward: the fake-quant encoder and the float
    heads, the training twin of ``combined_apply_int8``. Returns logits."""
    from ..nn.resnet_qat import qat_resnet50_apply

    feats = qat_resnet50_apply(moco.encoder, act_scales, x, truncate)
    return classifier.fc(moco.fc(global_avg_pool(feats)))


def combined_apply_int8(q_encoder, moco: TruncatedMoCo, classifier: Classifier,
                        x: torch.Tensor) -> torch.Tensor:
    """The int8 inference forward: the quantised encoder and the float
    heads; logits, as the eval ``combined_apply``."""
    from ..nn.resnet_int8 import resnet50_apply_int8

    feats = resnet50_apply_int8(q_encoder, x)
    return classifier.fc(moco.fc(global_avg_pool(feats)))
