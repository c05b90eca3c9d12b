"""SGD with momentum, the trainability mask and the parameter EMA
(``train/optim.py`` of the JAX package: ``label_tree`` ``:38-55``,
``param_ema`` ``:65-104``, ``find_ema_state`` and ``extract_ema_variables``
``:107-129``, ``sgd_momentum`` ``:132-150``).

The reference trains with ``optim.SGD(params, lr, momentum=0.9)`` over the
parameters that require a gradient. The JAX package writes that as
``optax.sgd`` inside ``optax.multi_transform``, with the batch-norm running
statistics and any user-frozen subtree (``--freeze_layers``) labelled
"freeze". Here the same update is written out to optax's formulas, on the
module's parameters in place: the trace m <- g + 0.9 m, then p <- p - lr m,
with a schedule evaluated at the update count before its increment, and
``clip_by_global_norm`` over the trainable parameters only. ``ema_decay``
keeps an exponential moving average of the updated trainable parameters
in the same state, for evaluation (``--ema_decay``).

On a data-parallel mesh (``core/mesh.py``) ``update`` takes each rank's
own gradients and reduces them first: one bucketed all-reduce, so the clip
sees the whole gradients; with ``zero1`` (``--zero1``) the trace and the
EMA are split over the ranks (``parallel/sharding.Zero1Layout``) and the
step reduce-scatters the gradients into each rank's shards, clips by the
global norm (the all-reduced sum of the shards' squares), updates each
rank's shards with the same arithmetic, and all-gathers the parameters.
``full_state`` gathers such a state for a save; ``load_full_state`` takes
each rank's shards from a whole one, so a run saved under one device
count resumes under another.

On a mesh with a model or spatial axis (``parallel/sharding.py``'s
factories) the plain update reduces the gradients over the rank's (data,
spatial) plane (``Mesh.replica_axis``), where the ranks' partial
gradients of every leaf are; ZeRO-1 splits the state over the data axis
(``Zero1Layout``: the gradients summed over the spatial axis first), and
the clip's global norm adds the squares of a head split over the model
axis (``parallel/tensor_parallel.py``) over that axis. ``shard_state``
puts a whole state into the ZeRO-1 layout, and with ``fsdp`` the split
parameters too (FSDP, ZeRO-3): between steps they hold only this rank's
shards, ``gather_params`` puts the whole tensors back for a step's
forward and backward, and the update (a reduce-scatter of the gradients
into the shards, the shards' update) releases them again; ``full_params``
gathers a copy of the model for evaluation and checkpoints.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

BN_STAT_KEYS = ("running_mean", "running_var")  # the JAX tree's "mean" and "var"
MOMENTUM = 0.9


def label_tree(model: torch.nn.Module,
               frozen_fn: Optional[Callable[[str], bool]] = None) -> Dict[str, str]:
    """{state-dict key: "train" | "freeze"} over the model's parameters and
    buffers. The batch norms' running statistics are always frozen (the
    forward updates them); ``frozen_fn`` gets each parameter's dotted path,
    whose module part is the JAX tree's path (the module tree mirrors it),
    and freezes those it returns True for."""
    labels = {}
    for key in model.state_dict():
        if key.split(".")[-1] in BN_STAT_KEYS:
            labels[key] = "freeze"
        elif frozen_fn is not None and frozen_fn(key):
            labels[key] = "freeze"
        else:
            labels[key] = "train"
    return labels


def sgd_momentum(learning_rate, momentum: float = MOMENTUM,
                 frozen_fn: Optional[Callable[[str], bool]] = None,
                 clip_norm: Optional[float] = None,
                 ema_decay: Optional[float] = None, mesh=None,
                 zero1: bool = False) -> Tuple[Callable, Callable]:
    """``torch.optim.SGD(momentum=0.9, dampening=0, nesterov=False)`` over
    the trainable parameters, as the JAX ``sgd_momentum``.

    Returns ``(init, update)``: ``init(model)`` the state ``{"count": 0,
    "trace": {name: zeros}}`` over the parameters ``label_tree`` labels
    "train" (the mask), ``update(model, grads, state)`` (grads by name) one
    update of those parameters and the state, in place. ``learning_rate``
    is a float or a schedule (``train/schedules.py``) of the update count.
    ``clip_norm`` scales the gradients by ``clip_norm / norm`` where their
    global norm exceeds it, as ``optax.clip_by_global_norm`` does.

    ``update.folds`` is the same update of K folds' stacked tensors
    (``--parallel_folds``). ``ema_decay`` (the JAX ``param_ema``, timm
    ModelEmaV2 semantics with no debias) adds ``"ema"``, a copy of the trainable parameters at init,
    and after each update ``ema <- decay * ema + (1 - decay) * p_new``.
    A frozen parameter never moves, so its average would be its init,
    which is its live value: the state keeps none for it. A decay outside
    (0, 1) raises JAX's ValueError. ``mesh`` (a ``core.mesh.Mesh``) makes
    ``update`` reduce each rank's gradients over it (its (data, spatial)
    plane); ``zero1`` shards the state over its data axis (no effect on
    one device, as in JAX). ``update.mesh`` is ``mesh``."""
    from ..core.mesh import data_parallel
    from ..parallel.tensor_parallel import split_leaves

    dp = data_parallel(mesh)
    if ema_decay is not None:
        ema_decay = float(ema_decay)
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
    schedule = learning_rate if callable(learning_rate) else None

    def init(model: torch.nn.Module) -> dict:
        labels = label_tree(model, frozen_fn)
        train = [(n, p) for n, p in model.named_parameters() if labels[n] == "train"]
        state = {"count": 0, "trace": {n: torch.zeros_like(p) for n, p in train}}
        if ema_decay is not None:
            # a real copy: the update writes the parameters in place
            state["ema"] = {n: p.detach().clone() for n, p in train}
        split = [n for n in split_leaves(model) if n in state["trace"]]
        if split:
            state["model_split"] = split
        if zero1 and dp is not None:
            shard_state(model, state, dp)
        return state

    def update(model: torch.nn.Module, grads: Dict[str, torch.Tensor], state: dict) -> None:
        params = dict(model.named_parameters())
        names = list(state["trace"])
        count = state["count"]
        lr = schedule(count) if schedule is not None else learning_rate
        with torch.no_grad():
            if "zero1" in state:
                _zero1_step(state["zero1"], params, names, grads, state, lr)
                state["count"] = count + 1
                return
            gs = [grads[n] for n in names]
            if dp is not None:  # one all-reduce a dtype
                gs = dp.replica_axis.all_reduce(gs)
            if clip_norm is not None:
                norm = _global_norm(dict(zip(names, gs)), (), state.get("model_split", ()),
                                    None, dp.model_axis if dp is not None else None)
                gs = [torch.where(norm < clip_norm, g, g / norm * clip_norm) for g in gs]
            for n, g in zip(names, gs):
                trace = state["trace"][n]
                trace.mul_(momentum).add_(g)
                params[n].add_(trace * -lr)
            if "ema" in state:
                # three multi-tensor launches for all the leaves, each
                # rounding as the JAX formula's three ops do
                emas = list(state["ema"].values())
                torch._foreach_mul_(emas, ema_decay)
                torch._foreach_add_(emas, torch._foreach_mul(
                    [params[n] for n in state["ema"]], 1.0 - ema_decay))
        state["count"] = count + 1

    def update_folds(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                     state: dict, active: Sequence[bool]) -> None:
        """``update`` of K folds at once (``--parallel_folds``,
        ``parallel/foldparallel.py``): ``params`` and ``grads`` by name and
        the state's trace and EMA hold the folds' tensors stacked on a
        leading axis, the state's ``"count"`` is the K folds' update counts
        (the schedule's rate is each fold's own), and each fold's gradients
        are clipped by their own global norm. A fold whose ``active`` entry
        is False keeps its parameters, trace, EMA and count: a
        zero-gradient step would still move its momentum."""
        names = list(state["trace"])
        counts = state["count"]
        device = state["trace"][names[0]].device
        lead = lambda t, like: t.reshape(-1, *([1] * (like.dim() - 1)))  # noqa: E731
        lrs = torch.tensor([schedule(c) if schedule is not None else learning_rate
                            for c in counts], dtype=torch.float64, device=device)
        on_folds = torch.tensor(list(active), device=device)
        with torch.no_grad():
            gs = [grads[n] for n in names]
            if clip_norm is not None:
                norm = torch.sqrt(sum(torch.sum(g * g, dim=tuple(range(1, g.dim())))
                                      for g in gs))
                gs = [torch.where(lead(norm < clip_norm, g), g, g / lead(norm, g) * clip_norm)
                      for g in gs]
            for n, g in zip(names, gs):
                trace, p, on = state["trace"][n], params[n], lead(on_folds, g)
                new_trace = trace * momentum + g
                p.copy_(torch.where(on, p + new_trace * lead(-lrs, g).to(g.dtype), p))
                trace.copy_(torch.where(on, new_trace, trace))
            for n, ema in state.get("ema", {}).items():
                new = ema * ema_decay + params[n] * (1.0 - ema_decay)
                ema.copy_(torch.where(lead(on_folds, ema), new, ema))
        state["count"] = [c + int(a) for c, a in zip(counts, active)]

    def _zero1_step(layout, params, names, grads, state, lr) -> None:
        """``update`` on ZeRO-1 state: gradients reduce-scattered into this
        rank's shards (replicated leaves all-reduced), the global clip,
        the trace and parameter update of this rank's part of each leaf,
        the EMA of those parts, then the parameters all-gathered."""
        shards, whole = layout.scatter_gradients({n: grads[n] for n in names})
        gs = {**shards, **whole}
        if clip_norm is not None:
            norm = _global_norm({**shards, **whole}, shards, state.get("model_split", ()),
                                layout.mesh, dp.model_axis if dp is not None else None)
            gs = {n: torch.where(norm < clip_norm, g, g / norm * clip_norm)
                  for n, g in gs.items()}
        for n in names:
            trace = state["trace"][n]
            trace.mul_(momentum).add_(gs[n])
            layout.part(n, params[n]).add_(trace * -lr)
        if "ema" in state:
            emas = list(state["ema"].values())
            torch._foreach_mul_(emas, ema_decay)
            torch._foreach_add_(emas, torch._foreach_mul(
                [layout.part(n, params[n]) for n in state["ema"]], 1.0 - ema_decay))
        if state.get("fsdp"):  # keep the shards, release the whole tensors
            for n in layout.sharded:
                params[n].data = layout.shard(n, params[n].data)
            return
        for n, t in layout.gather({n: layout.part(n, params[n])
                                   for n in layout.sharded}).items():
            params[n].copy_(t)

    update.folds = update_folds
    update.mesh = mesh
    return init, update


def _global_norm(gs: Dict[str, torch.Tensor], over_data, over_model, data_axis, model_axis):
    """The global norm of the gradients ``gs`` ({name: this rank's
    tensor}): the squares of the leaves in ``over_data`` (ZeRO-1 shards)
    summed over ``data_axis``, then those of the leaves in ``over_model``
    (heads split over the model axis) over ``model_axis``."""
    sums = {}
    for n, g in gs.items():
        key = (n in over_data, n in over_model)
        sums[key] = sums.get(key, 0.0) + torch.sum(g * g)
    keys = [k for k in ((True, False), (True, True)) if k in sums]
    for k, t in zip(keys, data_axis.all_reduce([sums[k] for k in keys]) if keys else ()):
        sums[k] = t
    keys = [k for k in ((False, True), (True, True)) if k in sums]
    for k, t in zip(keys, model_axis.all_reduce([sums[k] for k in keys]) if keys else ()):
        sums[k] = t
    terms = [sums[k] for k in ((True, False), (False, False), (False, True), (True, True))
             if k in sums]
    return torch.sqrt(sum(terms[1:], terms[0]) if terms else torch.zeros(()))


def shard_state(model: torch.nn.Module, opt_state: dict, mesh, fsdp: bool = False) -> dict:
    """A whole ``sgd_momentum`` state put into the ZeRO-1 layout over
    ``mesh``'s data axis, in place (``parallel.sharding.Zero1Layout`` of
    the trainable leaves): the trace and the EMA keep this rank's shards.
    With ``fsdp`` the split parameters of ``model`` too (their whole
    tensors released), and the update keeps them so."""
    from ..parallel.sharding import Zero1Layout

    params = dict(model.named_parameters())
    layout = Zero1Layout(mesh, {n: params[n].shape for n in opt_state["trace"]})
    with torch.no_grad():
        for part in ("trace", "ema"):
            if part in opt_state:
                opt_state[part] = {n: layout.shard(n, t) for n, t in opt_state[part].items()}
        if fsdp:
            for n in layout.sharded:
                params[n].data = layout.shard(n, params[n].data)
    opt_state["zero1"] = layout
    if fsdp:
        opt_state["fsdp"] = True
    return opt_state


def gather_params(model: torch.nn.Module, opt_state: dict) -> None:
    """An FSDP state's split parameters made whole in place (one
    all-gather; every rank calls it), for a step's forward and backward."""
    if not opt_state.get("fsdp"):
        return
    layout = opt_state["zero1"]
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, t in layout.gather({n: params[n].data for n in layout.sharded}).items():
            params[n].data = t


def full_params(model: torch.nn.Module, opt_state: dict) -> torch.nn.Module:
    """The model with whole parameters, for evaluation and checkpoints: a
    copy gathered from an FSDP state's shards (a collective: every rank
    calls it), else ``model`` itself."""
    if not opt_state.get("fsdp"):
        return model
    out = copy.deepcopy(model)
    gather_params(out, opt_state)
    return out


def full_state(opt_state: dict) -> dict:
    """The state with whole tensors: a ZeRO-1 state's trace and EMA
    gathered from every rank (a collective: every rank calls it); any other
    state as it is."""
    layout = opt_state.get("zero1")
    if layout is None:
        return opt_state
    out = {"count": opt_state["count"]}
    with torch.no_grad():
        for part in ("trace", "ema"):
            if part in opt_state:
                whole = layout.gather({n: opt_state[part][n] for n in layout.sharded})
                out[part] = {n: whole.get(n, t) for n, t in opt_state[part].items()}
    return out


def load_full_state(opt_state: dict, part: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Whole tensors ({name: tensor}) into ``opt_state[part]`` in place:
    each rank's shards under ZeRO-1."""
    layout = opt_state.get("zero1")
    with torch.no_grad():
        for name, t in tensors.items():
            dst = opt_state[part][name]
            dst.copy_(layout.part(name, t.to(dst.device)) if layout is not None else t)


def find_ema_state(opt_state) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA ({parameter name: average}) an ``sgd_momentum`` state
    carries, whole (gathered under ZeRO-1), or None."""
    if not isinstance(opt_state, dict) or "ema" not in opt_state:
        return None
    return full_state(opt_state)["ema"]


def extract_ema_variables(model: torch.nn.Module, opt_state) -> torch.nn.Module:
    """The evaluation model of an EMA run: a copy of ``model`` whose
    trainable parameters are the EMA's, with the live batch-norm running
    statistics (the forward updates those, outside the optimiser) and the
    live frozen parameters. ``model`` itself when the state carries no
    EMA."""
    ema = find_ema_state(opt_state)
    if ema is None:
        return model
    out = full_params(model, opt_state)
    out = copy.deepcopy(model) if out is model else out
    params = dict(out.named_parameters())
    with torch.no_grad():
        for n, t in ema.items():
            params[n].copy_(t)
    return out
