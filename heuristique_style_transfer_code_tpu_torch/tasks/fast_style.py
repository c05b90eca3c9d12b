"""Fast (feed-forward) style transfer (``tasks/fast_style.py`` of the JAX
package): train a net once per style, or once per gallery (a conditional
net), then stylise an image in one forward.

Training (``make_fast_style_train_step``, ``make_multi_style_train_step``,
driven by ``train_fast_style`` and ``train_multi_style``): one step takes a
staged uint8 batch to the device, runs ``eval_preprocess``, the frozen
encoder's content features under ``no_grad`` (no Grams), the net's forward,
the encoder's features and stage Grams of the stylised output and the loss
``sw * sum_l mean((G_l - T_l)^2) + cw * mean((f - f_c)^2) [+ tw *
mean(TV)]``; then the gradient with respect to the net's parameters only
(``torch.autograd.grad``: no encoder weight gets one) and Adam, written out
to optax's formulas, applied in place. On the card each of the net's 15
instance norms launches ``instance_norm_fwd`` and ``instance_norm_bwd``
and each stage Gram ``gram_fwd`` and ``gram_bwd``. The JAX step donates its
carry; here the net and the Adam state are updated in place, so a caller
that wants the initial weights copies them first. ``_drive_net_training``
adds resume, SIGTERM preemption and checkpoints.

``mesh=`` (``--devices N``; JAX ``:103-113``) splits each batch over the
ranks of a data-parallel mesh (``core/mesh.py``): the net is replicated,
each rank takes its rows' loss, the gradients and the loss are all-reduced
in one bucket and divided by N, so the loss is the global batch's mean and
Adam runs on its gradients on every rank alike. The instance norms are per
image, so the forward needs no collective. The ranks agree on a preemption
at each step; only rank 0 writes the in-progress file.

Serving: ``make_stylize_fn`` is the program ``uint8 (B, H, W, 3) ->
stylised uint8``; ``make_net_job_fn`` adapts it to
``StyleTransferService``'s job contract. On the card every instance norm of
the forward is the hand-written ``instance_norm_fwd`` kernel; there is no
backend option.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.convert import from_jax_tree, load_jax_tree, to_jax_tree
from ..core.mesh import data_parallel
from ..data.augment import eval_preprocess
from ..nn.transformer_net import (
    TransformerNet,
    net_n_styles,
    transformer_net_apply,
    transformer_net_init,
)
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD
from ..utils.debug import check_nan
from .style_transfer import ADAM_B1, ADAM_B2, ADAM_EPS, total_variation


def net_from_tree(tree: Any, device) -> TransformerNet:
    """A JAX-layout net tree (``style_net.npz``) -> the port's net on
    ``device``; width, depth and style count come from the tree's shapes."""
    scale = np.asarray(tree["in1"]["scale"])
    net = transformer_net_init(
        None, width=int(np.shape(tree["conv1"]["kernel"])[-1]), n_res=len(tree["res"]),
        n_styles=int(scale.shape[0]) if scale.ndim == 2 else None, device=device,
    )
    return load_jax_tree(net, tree)


def _stylize_body(net: TransformerNet, images_u8: torch.Tensor, crop: int,
                  compute_dtype: Optional[torch.dtype], style_weights=None) -> torch.Tensor:
    """uint8 staged crops -> stylised uint8 (round half to even, as
    ``jnp.round``)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=images_u8.device)
    images = eval_preprocess(images_u8, crop)
    out = transformer_net_apply(net, images, compute_dtype, style_weights)
    canvas = torch.clamp(out.float() * std + mean, 0.0, 1.0)
    return torch.round(canvas * 255.0).to(torch.uint8)


def make_stylize_fn(
    net: TransformerNet,
    *,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    style_weights=None,
) -> Callable:
    """``images_u8 (B, H, W, 3) -> stylised uint8`` on the net's device,
    one forward under ``torch.inference_mode`` (entered in the calling
    thread). The result is returned without a sync. For a conditional net
    ``style_weights`` ((S,) or (B, S)) fixes the style mix."""
    device = next(net.parameters()).device

    def stylize(images_u8):
        with torch.inference_mode():
            return _stylize_body(net, torch.as_tensor(images_u8).to(device), crop,
                                 compute_dtype, style_weights)

    return stylize


def make_net_job_fn(
    net: TransformerNet, *, crop: int = 224, compute_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """The forward under ``StyleTransferService``'s job contract
    ``(images_u8, style_w, job_ids) -> (u8, iters, per_loss)``: iters is 1,
    the per-image loss 0. On a conditional net the per-job ``style_w`` rows
    drive the conditional instance-norm affines. ``job.body(images_u8,
    style_w) -> (u8, per_loss)`` is its tensor program on tensors already on
    the net's device (``style_w`` read by a conditional net only), which
    ``deploy/artifact.py`` exports."""
    n_styles = net_n_styles(net)
    device = next(net.parameters()).device

    def body(images_u8, style_w):
        sw = None
        if n_styles is not None:
            sw = style_w.float()
            if sw.shape[-1] != n_styles:
                raise ValueError(f"service gallery width {sw.shape[-1]} != the "
                                 f"net's {n_styles} styles")
        out = _stylize_body(net, images_u8, crop, compute_dtype, sw)
        return out, out.new_zeros((out.shape[0],), dtype=torch.float32)

    def job(images_u8, style_w, job_ids):
        del job_ids
        with torch.inference_mode():
            sw = torch.as_tensor(style_w).to(device) if n_styles is not None else None
            out, per_loss = body(torch.as_tensor(images_u8).to(device), sw)
            return out, 1, per_loss

    job.body = body
    return job


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in float32, as optax computes it."""
    one, d = np.float32(1.0), np.float32(decay)
    return float(one - np.power(d, np.float32(count), dtype=np.float32))


def _make_optimizer(learning_rate, clip_norm: Optional[float] = None):
    """``(init, update)``: ``optax.adam(learning_rate)``, after
    ``optax.clip_by_global_norm(clip_norm)`` when it is given, written out
    to optax's formulas (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias corrections in float32). ``learning_rate`` is a float or a
    schedule (``train/schedules.py``) evaluated at the update count before
    its increment. ``init(net)`` gives the state ``{"count", "mu", "nu"}``
    (moments by parameter name); ``update(net, grads, state)`` applies one
    update to the net's parameters and the state, in place. Clipping scales
    by ``max_norm / norm`` only where the global norm exceeds it, as optax
    does (``torch.nn.utils.clip_grad_norm_`` would scale by ``max_norm /
    (norm + 1e-6)``)."""
    schedule = learning_rate if callable(learning_rate) else None

    def init(net: TransformerNet) -> dict:
        names = [n for n, _ in net.named_parameters()]
        params = [p for _, p in net.named_parameters()]
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in zip(names, params)},
                "nu": {n: torch.zeros_like(p) for n, p in zip(names, params)}}

    def update(net: TransformerNet, grads: Sequence[torch.Tensor], state: dict) -> None:
        named = list(net.named_parameters())
        count = state["count"]
        lr = schedule(count) if schedule is not None else learning_rate
        bc1 = _bias_correction(ADAM_B1, count + 1)
        bc2 = _bias_correction(ADAM_B2, count + 1)
        with torch.no_grad():
            if clip_norm is not None:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                grads = [torch.where(norm < clip_norm, g, g / norm * clip_norm) for g in grads]
            for (name, p), g in zip(named, grads):
                mu, nu = state["mu"][name], state["nu"][name]
                mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * (-lr))
        state["count"] = count + 1

    return init, update


def _features(extract_fn: Callable) -> Callable:
    """The encoder's features alone: ``extract_fn.features`` where
    ``make_extract_fn_gram_attention`` gives one (no Grams taken), else the
    first output of ``extract_fn``."""
    return getattr(extract_fn, "features", None) or (lambda images: extract_fn(images)[0])


def _net_loss(extract_fn, net, images, targets, weights, compute_dtype, style_w=None):
    """The JAX step's ``loss_fn``: the scalar f32 loss of the stylised batch
    against per-layer targets of leading dim 1 (broadcast) or B."""
    sw, cw, tw = weights
    with torch.no_grad():
        content_feats = _features(extract_fn)(images).float()
    stylised = transformer_net_apply(net, images, compute_dtype, style_w)
    feats, grams = extract_fn(stylised)
    style = 0.0
    for g, t in zip(grams, targets):
        style = style + torch.mean(torch.square(g.float() - t.float()))
    content = torch.mean(torch.square(feats.float() - content_feats))
    loss = sw * style + cw * content
    if tw != 0.0:
        loss = loss + tw * torch.mean(total_variation(stylised))
    return loss


def _make_step(extract_fn, update, weights, crop, compute_dtype, targets_of, mesh=None):
    """One training step; ``targets_of(device, *style_args)`` gives the
    per-layer targets and the (B, S) style rows (None for a single-style
    net). On a data-parallel ``mesh`` the arguments are this rank's rows
    and the loss and gradients the global batch's (module docstring)."""
    dp = data_parallel(mesh)

    def step(net, opt_state, images_u8, *style_args):
        device = next(net.parameters()).device
        images = eval_preprocess(torch.as_tensor(images_u8).to(device), crop)
        targets, style_w = targets_of(device, *style_args)
        loss = _net_loss(extract_fn, net, images, targets, weights, compute_dtype, style_w)
        grads = torch.autograd.grad(loss, list(net.parameters()))
        loss = loss.detach()
        if dp is not None:
            *grads, loss = dp.all_reduce(list(grads) + [loss])
            grads = [g / dp.world_size for g in grads]
            loss = loss / dp.world_size
        update(net, grads, opt_state)
        return net, opt_state, loss

    return step


def make_fast_style_train_step(
    extract_fn: Callable,
    *,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    learning_rate=1e-3,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    clip_norm: Optional[float] = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_opt_state, step)``. ``step(net, opt_state, images_u8,
    style_grams) -> (net, opt_state, loss)`` updates the net and the state
    in place and returns the loss as a device tensor, without a sync;
    ``images_u8`` is a staged uint8 (B, H, W, 3) batch (numpy or tensor),
    ``style_grams`` the per-layer targets of one style image, leading dim 1
    (``encode_style_grams``). ``mesh``: the data-parallel step (module
    docstring)."""
    init, update = _make_optimizer(learning_rate, clip_norm)
    weights = (float(style_weight), float(content_weight), float(tv_weight))
    return init, _make_step(extract_fn, update, weights, crop, compute_dtype,
                            lambda device, grams: (grams, None), mesh)


def make_multi_style_train_step(
    extract_fn: Callable,
    *,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    learning_rate=1e-3,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    clip_norm: Optional[float] = None,
) -> Tuple[Callable, Callable]:
    """The conditional net's step: ``step(net, opt_state, images_u8,
    style_w, gram_stacks) -> (net, opt_state, loss)``. ``style_w`` is the
    per-image (B, S) one-hot (or blend) row, which selects the net's
    instance-norm affines and the targets ``style_w @ stack`` per layer;
    ``gram_stacks`` the per-layer (S, ...) stacks of
    ``encode_style_gram_stacks``. On a data-parallel ``mesh`` ``style_w``
    holds this rank's rows."""
    init, update = _make_optimizer(learning_rate, clip_norm)
    weights = (float(style_weight), float(content_weight), float(tv_weight))

    def targets_of(device, style_w, gram_stacks):
        w = torch.as_tensor(style_w, dtype=torch.float32).to(device)
        return [torch.einsum("bk,k...->b...", w, s.float()) for s in gram_stacks], w

    return init, _make_step(extract_fn, update, weights, crop, compute_dtype, targets_of, mesh)


def encode_style_gram_stacks(extract_fn: Callable, styles_u8, crop: int = 224,
                             device="cuda") -> List[torch.Tensor]:
    """Per-layer f32 (S, ...) target-Gram stacks of a gallery of uint8
    style images, from one encoder pass on ``device``."""
    from .style_service import _to_canvas

    canvas = np.stack([_to_canvas(np.asarray(s), crop) for s in styles_u8])
    with torch.no_grad():
        images = eval_preprocess(torch.from_numpy(canvas).to(torch.device(device)), crop)
        return [g.float() for g in extract_fn(images)[1]]


def encode_style_grams(extract_fn: Callable, style_u8: np.ndarray, crop: int = 224,
                       device="cuda") -> List[torch.Tensor]:
    """Per-layer f32 target Grams of one style image, leading dim 1."""
    return encode_style_gram_stacks(extract_fn, [style_u8], crop, device)


_INPROGRESS_NET = "_inprogress_style_net.npz"


def style_net_signature(hyperparameters: dict) -> str:
    """Identity of a fit (resume safety): the whole hyperparameter dict,
    so that a resume under other styles, weights or net shape is refused."""
    return json.dumps(hyperparameters, sort_keys=True, default=str)


def _save_net_inprogress(save_dir, net, opt_state, epoch, step_in_epoch, seen, history,
                         signature, async_writer=None):
    """One atomic file: the net and the Adam moments in the JAX layout
    (``to_jax_tree``), the update count, the position (epoch, batches
    consumed in it, global step), the loss history and the signature. The
    port reads its own files; a JAX package's in-progress file is not read."""
    from ..checkpoint.io import save_pytree_npz

    tree = {
        "params": to_jax_tree(net),
        "opt": {"count": np.int64(opt_state["count"]),
                "mu": to_jax_tree(net, opt_state["mu"]),
                "nu": to_jax_tree(net, opt_state["nu"])},
        "epoch": int(epoch),
        "step_in_epoch": int(step_in_epoch),
        "seen": int(seen),
        "history": np.asarray(history, np.float64),
        "signature": np.asarray(signature),
    }
    path = os.path.join(save_dir, _INPROGRESS_NET)
    if async_writer is not None:
        async_writer.submit(tree, path)  # host copy now, write in the background
    else:
        save_pytree_npz(tree, path)


def _load_net_inprogress(save_dir, signature):
    from ..checkpoint.io import load_pytree_npz

    path = os.path.join(save_dir, _INPROGRESS_NET)
    if not os.path.exists(path):
        return None
    st = load_pytree_npz(path)
    found = str(np.asarray(st["signature"]))
    if found != signature:
        raise ValueError(
            "--resume: this run's configuration does not match the "
            "interrupted run's (styles/weights/net shape/epochs differ).\n"
            f"  was: {found}\n  now: {signature}"
        )
    return st


def clear_net_inprogress(save_dir) -> None:
    p = os.path.join(save_dir, _INPROGRESS_NET)
    if os.path.exists(p):
        os.unlink(p)


def _restore(net, opt_state, st) -> None:
    """The in-progress file's net and Adam state into ``net`` and
    ``opt_state``, in place."""
    load_jax_tree(net, st["params"])
    with torch.no_grad():
        for key in ("mu", "nu"):
            for name, t in from_jax_tree(st["opt"][key]).items():
                opt_state[key][name].copy_(t)
    opt_state["count"] = int(st["opt"]["count"])


def _drive_net_training(
    dispatch: Callable,
    init_opt: Callable,
    net: TransformerNet,
    loader,
    *,
    epochs: int,
    log_fn,
    log_every: int,
    label: str,
    save_dir=None,
    resume: bool = False,
    checkpoint_every: int = 200,
    async_checkpoint: bool = False,
    signature=None,
    mesh=None,
) -> Tuple[TransformerNet, List[float]]:
    """The loop behind ``train_fast_style`` and ``train_multi_style``.

    ``dispatch(net, opt_state, images_u8, seen)`` runs one step. With
    ``resume=True`` (needs ``save_dir``) a SIGTERM is honoured at the next
    batch boundary (the position is checkpointed and ``PreemptedError``
    raised), and an in-progress checkpoint is written every
    ``checkpoint_every`` steps and at each epoch end; rerunning the same
    configuration continues where it stopped (the loader replays the
    interrupted epoch's order and skips the consumed batches,
    ``HostLoader.set_position``). ``async_checkpoint`` writes them from a
    background thread. The loss is fetched every ``log_every`` steps, at
    the first and at the end. On a data-parallel ``mesh`` the ranks agree
    on a preemption at each step and rank 0 alone writes."""
    from ..train.preemption import (
        PreemptedError,
        clear_preemption,
        install_sigterm_handler,
        preemption_agreed,
    )

    acw = None
    dp = data_parallel(mesh)
    main = dp is None or dp.is_main
    clear_preemption()  # a stale flag from an earlier run in this process
    if resume:
        if save_dir is None:
            raise ValueError("resume=True requires save_dir")
        install_sigterm_handler()
        if async_checkpoint and main:
            from ..checkpoint.async_io import AsyncCheckpointWriter

            acw = AsyncCheckpointWriter()

    opt_state = init_opt(net)
    history: List[float] = []
    start_epoch = start_step = seen = 0
    if resume:
        st = _load_net_inprogress(save_dir, signature)
        if st is not None:
            _restore(net, opt_state, st)
            start_epoch = int(st["epoch"])
            start_step = int(st["step_in_epoch"])
            seen = int(st["seen"])
            history = [float(x) for x in np.asarray(st["history"]).ravel()]
            log_fn(
                f"{label}: reprise à l'epoch {start_epoch + 1} "
                f"(step {seen}, {start_step} batch(s) déjà consommés)"
            )

    def save(epoch, step_in_epoch):
        if main:
            _save_net_inprogress(save_dir, net, opt_state, epoch, step_in_epoch, seen, history,
                                 signature, async_writer=acw)

    loss = None
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, int(epochs)):
            k = start_step if epoch == start_epoch else 0
            if k:
                if not hasattr(loader, "set_position"):
                    # replaying from batch 0 would apply the consumed batches twice
                    raise ValueError(
                        f"mid-epoch resume (step_in_epoch={k}) needs a loader with "
                        "set_position(epoch, skip_batches) — HostLoader has it; wrap "
                        f"custom loaders, got {type(loader).__name__}"
                    )
                loader.set_position(epoch, k)
            elif hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            for batch in loader:
                if resume and preemption_agreed(mesh):
                    if acw is not None:
                        acw.wait()
                    save(epoch, k)
                    if acw is not None:
                        acw.wait()
                    raise PreemptedError(
                        0, epoch,
                        message=(f"preempted: progress through step {seen} (epoch "
                                 f"{epoch + 1}, batch {k}) is checkpointed; rerun with "
                                 "--resume to continue"),
                    )
                images_u8 = batch["image"] if isinstance(batch, dict) else batch[0]
                net, opt_state, loss = dispatch(net, opt_state, images_u8, seen)
                seen += 1
                k += 1
                check_nan("the style net's loss", loss)  # reads it under --debug_nans only
                if seen % int(log_every) == 0 or seen == 1:
                    lv = float(loss)
                    history.append(lv)
                    log_fn(f"{label} epoch {epoch + 1}/{epochs} step {seen} "
                           f"loss {lv:.6f} ({time.perf_counter() - t0:.1f}s)")
                if resume and checkpoint_every and seen % int(checkpoint_every) == 0:
                    save(epoch, k)
            if resume:
                save(epoch + 1, 0)
    finally:
        if acw is not None:
            acw.close()
    if seen and loss is not None:
        history.append(float(loss))  # the history always ends at the final state
    return net, history


def balanced_style_indices(n: int, n_styles: int, rng) -> np.ndarray:
    """One batch's style draw: every style ``floor(n/S)`` or ``ceil(n/S)``
    times, the extra draws going to styles ``rng`` picks, order shuffled
    (``rng``: a numpy Generator or RandomState)."""
    idx = np.tile(np.arange(n_styles), n // n_styles)
    rem = n % n_styles
    if rem:
        extra = rng.permutation(n_styles)[:rem]
        idx = np.concatenate([idx, extra])
    rng.shuffle(idx)
    return idx


def _style_onehot(seed: int, seen: int, n: int, n_styles: int, style_sampling: str):
    """Step ``seen``'s (n, S) one-hot style rows from
    ``np.random.default_rng([seed, seen])`` (counter-based, so a resumed run
    draws what a fresh one would)."""
    rng = np.random.default_rng([seed, seen])
    onehot = np.zeros((n, n_styles), np.float32)
    if style_sampling == "balanced":
        idx = balanced_style_indices(n, n_styles, rng)
    else:
        idx = rng.integers(0, n_styles, size=n)
    onehot[np.arange(n), idx] = 1.0
    return onehot


def train_multi_style(
    net: TransformerNet,
    extract_fn: Callable,
    loader,
    styles_u8,
    *,
    epochs: int = 2,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    learning_rate=1e-3,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    seed: int = 0,
    log_fn=print,
    log_every: int = 50,
    clip_norm: Optional[float] = None,
    save_dir=None,
    resume: bool = False,
    checkpoint_every: int = 200,
    async_checkpoint: bool = False,
    signature=None,
    style_sampling: str = "balanced",
) -> Tuple[TransformerNet, List[float]]:
    """Train one conditional net on a gallery (``styles_u8``, aligned with
    the net's style axis): each content image trains against a style drawn
    per step from ``np.random.default_rng([seed, step])``, ``"balanced"``
    (every batch covers the gallery as evenly as it can) or ``"uniform"``.
    The net is updated in place; resume and preemption as in
    ``_drive_net_training``."""
    if style_sampling not in ("balanced", "uniform"):
        raise ValueError(f"style_sampling must be 'balanced' or 'uniform', got "
                         f"{style_sampling!r}")
    n_styles = net_n_styles(net)
    if n_styles is None:
        raise ValueError("train_multi_style needs a conditional net "
                         "(transformer_net_init(n_styles=S))")
    if len(styles_u8) != n_styles:
        raise ValueError(f"{len(styles_u8)} style images for a {n_styles}-style net")
    init_opt, step = make_multi_style_train_step(
        extract_fn, style_weight=style_weight, content_weight=content_weight,
        tv_weight=tv_weight, learning_rate=learning_rate, crop=crop,
        compute_dtype=compute_dtype, clip_norm=clip_norm, mesh=mesh,
    )
    device = next(net.parameters()).device
    gram_stacks = encode_style_gram_stacks(extract_fn, styles_u8, crop, device)
    dp = data_parallel(mesh)

    def dispatch(net, opt_state, images_u8, seen):
        if dp is None:
            onehot = _style_onehot(seed, seen, images_u8.shape[0], n_styles, style_sampling)
        else:  # the global batch's draw, this rank's rows of it
            onehot = dp.local(_style_onehot(seed, seen, images_u8.shape[0] * dp.world_size,
                                            n_styles, style_sampling))
        return step(net, opt_state, images_u8, onehot, gram_stacks)

    return _drive_net_training(
        dispatch, init_opt, net, loader, epochs=epochs, log_fn=log_fn, log_every=log_every,
        label=f"fast-style ({n_styles} styles)", save_dir=save_dir, resume=resume,
        checkpoint_every=checkpoint_every, async_checkpoint=async_checkpoint,
        signature=signature, mesh=mesh,
    )


def train_fast_style(
    net: TransformerNet,
    extract_fn: Callable,
    loader,
    style_u8: np.ndarray,
    *,
    epochs: int = 2,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    learning_rate=1e-3,
    crop: int = 224,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    log_fn=print,
    log_every: int = 50,
    clip_norm: Optional[float] = None,
    save_dir=None,
    resume: bool = False,
    checkpoint_every: int = 200,
    async_checkpoint: bool = False,
    signature=None,
) -> Tuple[TransformerNet, List[float]]:
    """Train a single-style net over a content loader for ``epochs``:
    ``loader`` yields ``HostLoader`` batch dicts (the "image" entry; labels
    are ignored) or tuples with the uint8 images first. Returns (the net,
    the logged loss history). The net is updated in place (copy it first
    to keep the initial weights); resume and preemption as in
    ``_drive_net_training``. ``mesh``: data-parallel training over its
    ranks, the loader giving each rank its rows (module docstring)."""
    init_opt, step = make_fast_style_train_step(
        extract_fn, style_weight=style_weight, content_weight=content_weight,
        tv_weight=tv_weight, learning_rate=learning_rate, crop=crop,
        compute_dtype=compute_dtype, clip_norm=clip_norm, mesh=mesh,
    )
    style_grams = encode_style_grams(extract_fn, style_u8, crop, next(net.parameters()).device)

    def dispatch(net, opt_state, images_u8, seen):
        del seen
        return step(net, opt_state, images_u8, style_grams)

    return _drive_net_training(
        dispatch, init_opt, net, loader, epochs=epochs, log_fn=log_fn, log_every=log_every,
        label="fast-style", save_dir=save_dir, resume=resume,
        checkpoint_every=checkpoint_every, async_checkpoint=async_checkpoint,
        signature=signature, mesh=mesh,
    )


def net_quality_per_image(
    extract_fn: Callable,
    net: TransformerNet,
    images_u8,
    style_grams,
    *,
    crop: int = 224,
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    style_weights=None,
) -> torch.Tensor:
    """The per-image (B,) f32 content+style loss of the net's one-pass
    output, scored by the loop's own objective
    (``make_per_image_content_style_loss``)."""
    from .style_transfer import make_per_image_content_style_loss

    loss_fn = make_per_image_content_style_loss(extract_fn, style_weight, content_weight,
                                                tv_weight)
    device = next(net.parameters()).device
    with torch.no_grad():
        images = eval_preprocess(torch.as_tensor(images_u8).to(device), crop)
        content_feats = _features(extract_fn)(images).float()
        stylised = transformer_net_apply(net, images, compute_dtype, style_weights)
        return loss_fn(stylised, style_grams, content_feats)


def compare_net_to_loop(
    extract_fn: Callable,
    net: TransformerNet,
    images_u8,
    style_grams,
    *,
    crop: int = 224,
    iteration_grid=(100, 300, 500),
    style_weight: float = 1.0,
    content_weight: float = 1.0,
    tv_weight: float = 0.0,
    learning_rates=(0.01, 0.05),
    compute_dtype: Optional[torch.dtype] = None,
    style_weights=None,
) -> dict:
    """Price the one-pass net in iterations of the content+style loop
    (``make_content_style_optimizer``, content-initialised, threshold 0)
    on held-out ``images_u8``: the net's per-image loss against the
    loop's after each ``k`` of ``iteration_grid``, for every Adam lr of
    ``learning_rates``, the denominator at each ``k`` being the strongest
    loop of the sweep. Returns the JAX package's dict (``net_loss_mean``,
    ``net_loss_per_image``, ``loop_loss_mean``, ``loop_loss_per_image``,
    ``loop_loss_mean_by_lr``, ``loop_best_lr``, ``learning_rates``,
    ``worth_iterations``: the largest ``k`` whose best loop mean is still
    at least the net's, 0 if none)."""
    from .style_transfer import make_content_style_optimizer

    net_per = net_quality_per_image(
        extract_fn, net, images_u8, style_grams, crop=crop, style_weight=style_weight,
        content_weight=content_weight, tv_weight=tv_weight, compute_dtype=compute_dtype,
        style_weights=style_weights,
    ).cpu().numpy()
    device = next(net.parameters()).device
    images = eval_preprocess(torch.as_tensor(images_u8).to(device), crop)
    with torch.no_grad():
        content_feats = _features(extract_fn)(images).float()
    pixels0 = images.float()
    bcast = [g.expand((images.shape[0],) + tuple(g.shape[1:])) if g.shape[0] == 1 else g
             for g in style_grams]
    lrs = tuple(float(lr) for lr in learning_rates)
    by_lr: Dict[float, Dict[int, float]] = {lr: {} for lr in lrs}
    per_by_lr: Dict[float, Dict[int, np.ndarray]] = {lr: {} for lr in lrs}
    for lr in lrs:
        for k in iteration_grid:
            optimise = make_content_style_optimizer(extract_fn, style_weight, content_weight, lr,
                                                    int(k), 0.0, tv_weight=tv_weight)
            _, iters, per = optimise(pixels0, bcast, content_feats)
            if int(iters) != int(k):
                raise RuntimeError(f"loop ran {int(iters)} iterations, expected the full "
                                   f"cap {int(k)} (a threshold of 0 never stops early)")
            per_by_lr[lr][int(k)] = per.cpu().numpy()
            by_lr[lr][int(k)] = float(np.mean(per_by_lr[lr][int(k)]))
    loop_mean, loop_per, best_lr = {}, {}, {}
    for k in (int(k) for k in iteration_grid):
        lr_star = min(lrs, key=lambda lr: by_lr[lr][k])
        best_lr[k] = lr_star
        loop_mean[k] = by_lr[lr_star][k]
        loop_per[k] = per_by_lr[lr_star][k]
    net_mean = float(np.mean(net_per))
    worth = 0
    for k in sorted(loop_mean):
        if loop_mean[k] >= net_mean:
            worth = k
    return {
        "net_loss_mean": net_mean,
        "net_loss_per_image": net_per,
        "loop_loss_mean": loop_mean,
        "loop_loss_per_image": loop_per,
        "loop_loss_mean_by_lr": by_lr,
        "loop_best_lr": best_lr,
        "learning_rates": lrs,
        "worth_iterations": worth,
    }
