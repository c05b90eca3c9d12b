"""Grad-CAM of the family-1 model (``tasks/gradcam.py`` of the JAX package;
the reference's pytorch_grad_cam target is the last bottleneck's conv3 of
the last executed stage).

No module hooks: the forward is split by hand at the target activation A,
the ``conv3`` output of the last executed stage's last block (before its
``bn3`` and its residual). A is computed without a graph; the continuation
(``bn3``, the residual add, ReLU, the global average pool, ``moco.fc``,
``classifier.fc``, the picked logit, the sum) runs with autograd from A
alone, so one ``torch.autograd.grad`` gives dscore/dA and no weight
gradient. The block's submodules are called directly, as the JAX code
calls ``_bottleneck_apply``'s pieces.

The CAM runs in the model's dtype (f32 for a model loaded by the CLIs,
whatever ``--precision`` says) and outside ``torch.inference_mode``, which
cannot record a graph: ``gradcam_moco`` leaves it where its caller is in
it. The overlay writer imports OpenCV and Pillow.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.device import device_of
from ..data.augment import eval_preprocess
from ..nn.resnet import _STAGES, resnet50_apply
from ..ops.pooling import global_avg_pool
from ..ops.resize import resize_image


def _cam_for_moco(model, images: torch.Tensor, targets: torch.Tensor,
                  truncate: int) -> torch.Tensor:
    """images: preprocessed (N, 224, 224, 3) on the model's device; targets
    (N,) int64. Returns the CAM (N, h, w) in [0, 1]."""
    enc = model.moco.encoder
    n_stages = min(truncate, 8) - 4
    if n_stages < 1:
        raise ValueError(
            "Grad-CAM targets a residual stage's conv3; truncate_layer must be "
            f">= 5 (got {truncate}: stem-only encoder has no target layer)."
        )
    with torch.no_grad():
        h, _ = resnet50_apply(enc, images, truncate=4)
        for name, _, _, _ in _STAGES[: n_stages - 1]:
            for block in getattr(enc, name):
                h = block(h)
        blocks = getattr(enc, _STAGES[n_stages - 1][0])
        for block in blocks[:-1]:
            h = block(h)
        last = blocks[-1]
        # the target: the last block's conv3 output (pre-bn3, pre-residual)
        pre = torch.relu(last.bn1(last.conv1(h)))
        pre = torch.relu(last.bn2(last.conv2(pre)))
        a = last.conv3(pre)
        identity = last.downsample(h) if last.downsample is not None else h
    a.requires_grad_(True)
    with torch.enable_grad():
        out = torch.relu(last.bn3(a) + identity)
        logits = model.classifier.fc(model.moco.fc(global_avg_pool(out)))
        score = torch.gather(logits, 1, targets[:, None])[:, 0].sum()
        (grads,) = torch.autograd.grad(score, a)
    with torch.no_grad():
        weights = grads.mean(dim=(1, 2), keepdim=True)  # GAP of the gradients
        cam = torch.relu((weights * a).sum(dim=-1))  # (N, h, w)
        lo = cam.amin(dim=(1, 2), keepdim=True)
        hi = cam.amax(dim=(1, 2), keepdim=True)
        return (cam - lo) / torch.clamp(hi - lo, min=1e-7)


def gradcam_moco(model, images_u8, targets, truncate: int = 8,
                 out_size: int = 224) -> torch.Tensor:
    """Staged uint8 images (N, S, S, 3) and target classes -> CAMs
    (N, out_size, out_size) in [0, 1], f32 on the model's device. Called
    inside ``torch.inference_mode`` it leaves it for its own work, so the
    gradient is recorded all the same."""
    device = device_of(model)
    with torch.inference_mode(False):
        images = eval_preprocess(torch.tensor(np.asarray(images_u8)).to(device))
        targets = torch.as_tensor(np.asarray(targets), dtype=torch.int64, device=device)
        cam = _cam_for_moco(model, images, targets, truncate)
        with torch.no_grad():
            cam = resize_image(cam[..., None], out_size, out_size)[..., 0]
            return torch.clamp(cam, 0.0, 1.0)


# the cv2 colormaps by the names the CLI's --colormap takes (cv2 constants,
# resolved when OpenCV is imported)
_CV2_COLORMAP_NAMES = {
    "autumn": "COLORMAP_AUTUMN", "bone": "COLORMAP_BONE", "jet": "COLORMAP_JET",
    "winter": "COLORMAP_WINTER", "rainbow": "COLORMAP_RAINBOW", "ocean": "COLORMAP_OCEAN",
    "summer": "COLORMAP_SUMMER", "spring": "COLORMAP_SPRING", "cool": "COLORMAP_COOL",
    "hsv": "COLORMAP_HSV", "pink": "COLORMAP_PINK", "hot": "COLORMAP_HOT",
    "inferno": "COLORMAP_INFERNO", "magma": "COLORMAP_MAGMA", "plasma": "COLORMAP_PLASMA",
    "viridis": "COLORMAP_VIRIDIS", "cividis": "COLORMAP_CIVIDIS", "turbo": "COLORMAP_TURBO",
}


def _cv2_colormap(name: str) -> int:
    """The cv2 colormap of ``name`` (case-insensitive); "hot" for a name
    it does not know."""
    import cv2

    return getattr(cv2, _CV2_COLORMAP_NAMES.get(str(name).lower(), "COLORMAP_HOT"))


def create_custom_colormap():
    """Blue -> red gradient colormap (the reference's helper); imports
    matplotlib."""
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list("custom_cmap", [(0, 0, 1), (1, 0, 0)], N=256)


def generate_heatmap_overlays(
    cam: np.ndarray,
    original_path: str,
    save_path: Optional[str],
    colormap: str = "hot",
) -> np.ndarray:
    """show_cam_on_image's equivalent: [original | coloured overlay |
    grayscale CAM] side by side, f32 in [0, 1]; written as a BGR PNG to
    ``save_path`` when given."""
    import cv2
    from PIL import Image

    cam = np.asarray(cam, dtype=np.float32)
    size = cam.shape[0]
    orig = Image.open(original_path).convert("RGB").resize((size, size))
    orig = np.asarray(orig, dtype=np.float32) / 255.0

    heat = cv2.applyColorMap(np.uint8(255 * cam), _cv2_colormap(colormap))
    heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    overlay = heat + orig
    overlay = overlay / max(float(overlay.max()), 1e-7)

    gray = np.repeat(cam[..., None], 3, axis=-1)
    combined = np.hstack((orig, overlay, gray))
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        bgr = cv2.cvtColor((combined * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imwrite(save_path, bgr)
    return combined
