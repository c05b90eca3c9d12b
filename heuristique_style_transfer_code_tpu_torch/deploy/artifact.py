"""Serving artifacts through ``torch.export`` (``deploy/artifact.py`` of the
JAX package).

One file carries the whole serving program and its weights, so a serving
host needs no model code, config or checkpoint: :func:`load_infer_artifact`
and :func:`load_style_artifact` give callables for the batchers' hooks.

- **Inference** (:func:`export_infer_artifact`): the fused program the
  batcher dispatches (uint8 frames, optional I420 to RGB, normalisation,
  forward, softmax in f32; ``tasks/camera.camera_body``, the function the
  live infer functions run) traced by ``torch.export`` (non-strict): the
  model's parameters and buffers are the program's state, the int8 tensors
  and the other tensors it reaches its constants. ``batch_size=None``
  traces a symbolic batch (``Dim("b", min=1)``, from an example batch of
  2): one program for every batch size.
- **Style** (:func:`export_style_artifact`): one entry per ladder size. A
  net job is one program. An iterative job is three programs and a host
  loop, not one loop program: ``prepare`` (uint8 in; the starting pixels
  and the loop's tensors out: target Grams, the gallery blend, content
  features), ``step`` (one masked Adam iteration with the loss's gradient
  inside the graph) and ``finish`` (pixels to uint8);
  ``tasks/style_service.loop_job`` runs them as the live service runs its
  own. ``torch.export`` does not trace ``torch.autograd.grad`` through a
  ReLU's saved output, so the step is traced by ``make_fx`` first (fake
  tensors, below autograd: its backward is plain ops and the
  ``hst::*_bwd`` kernels) and that graph is exported.

The hand-written kernels are ``torch.library`` ops (``ops/kernels``), so
the exported graphs hold ``hst::gram_fwd``, ``hst::instance_norm_fwd`` and
the rest as nodes and run the kernels on the card; this module imports
``ops.kernels`` so that :func:`torch.export.load` finds them.

The container is JAX's: an npz written atomically, a ``meta`` JSON and the
bytes of ``torch.export.save`` as uint8 arrays, one a platform (and for
style a platform, batch size and program). The formats are
``hst-infer-artifact-torch`` and ``hst-style-artifact-torch``: the JAX
loader refuses them, and this one refuses a JAX StableHLO file.
"""
from __future__ import annotations

import io
import json
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels  # noqa: F401  (registers the hst:: ops for torch.export.load)

ARTIFACT_FORMAT = "hst-infer-artifact-torch"
STYLE_ARTIFACT_FORMAT = "hst-style-artifact-torch"
ARTIFACT_VERSION = 1
_JAX_FORMATS = ("hst-infer-artifact", "hst-style-artifact")
STYLE_PROGRAMS = {"net": ("job",), "loop": ("prepare", "step", "finish")}


def _platform_device(platform: str) -> torch.device:
    """``cuda`` (alias ``gpu``) or ``cpu`` -> its device; a platform whose
    device this host lacks raises, ``tpu`` and anything else too."""
    p = platform.strip().lower()
    if p in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"platform {platform!r}: CUDA is not available on this host")
        return torch.device("cuda", torch.cuda.current_device())
    if p == "cpu":
        return torch.device("cpu")
    raise ValueError(f"platform {platform!r} is not one the port exports for (cuda, gpu, cpu)")


def _platforms(platforms: Optional[Sequence[str]], default: torch.device):
    """[(name, device)] in order, each device once; default the model's."""
    out = {}
    for p in (platforms if platforms else [default.type]):
        dev = _platform_device(p)
        out.setdefault(dev.type, dev)
    return list(out.items())


def _on(ep, home: torch.device, device: torch.device):
    """``ep`` (traced on ``home``) for ``device``: itself, or its state and
    device arguments moved there."""
    if device.type == home.type:
        return ep
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(ep, device)


def _serialize(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _deserialize(blob: bytes):
    return torch.export.load(io.BytesIO(blob))


def _module(ep) -> torch.nn.Module:
    """The callable of a loaded program, its weights frozen (a step's
    outputs feed the next step: no autograd graph may grow across them)."""
    return ep.module().requires_grad_(False)


class _Program(torch.nn.Module):
    """``fn(*inputs)`` as a module; ``model``, where it is an
    ``nn.Module``, a submodule, so that its parameters and buffers are the
    exported program's state (tensors ``fn`` reaches otherwise travel as
    the program's constants)."""

    def __init__(self, fn: Callable, model=None):
        super().__init__()
        self.fn = fn
        self.model = model if isinstance(model, torch.nn.Module) else None

    def forward(self, *inputs):
        return self.fn(*inputs)


def _prune(ep):
    """Drop what ``torch.export`` records beside each ``.to(dtype)``: the
    ``_assert_tensor_metadata`` check, and the ``.to`` itself where its
    input already has that dtype and it asks for nothing else (no
    ``copy``, ``non_blocking`` or ``memory_format``: eagerly it returns its
    input). Half the
    nodes of a ResNet's graph, each a Python call when the program runs;
    what the program computes is unchanged."""
    graph = ep.graph_module.graph
    outputs = set(next(n for n in graph.nodes if n.op == "output").all_input_nodes)
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs and node not in outputs and isinstance(node.args[0], torch.fx.Node)
              and getattr(node.args[0].meta.get("val"), "dtype", None) == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def _export(fn: Callable, model, example: tuple, dynamic_shapes=None):
    """``torch.export`` (non-strict) of ``fn(*example)`` under ``no_grad``
    with ``model``'s weights as state, after one eager call on the
    example: the port's cached device constants (pooling and resize
    matrices, the unit affine rows) are made there, never as traced
    tensors. Returns (program, eager output), the program ``_prune``'d."""
    prog = _Program(fn, model)
    with torch.no_grad():
        out = prog(*example)
        ep = torch.export.export(prog, example, dynamic_shapes=dynamic_shapes, strict=False)
    return _prune(ep), out


def _fused_infer(forward_eval: Callable, *, crop: int, transport: str,
                 compute_dtype=None) -> Callable:
    """The batch body the serving batcher dispatches (``tasks/serving.py``):
    uint8 frames on the model's device -> probabilities."""
    from ..tasks.camera import camera_body, camera_body_yuv

    if transport == "yuv420":
        return camera_body_yuv(forward_eval, crop, compute_dtype=compute_dtype, batch=-1)
    if transport == "rgb":
        return camera_body(forward_eval, compute_dtype=compute_dtype, batch=-1,
                           host_downscale=True)
    raise ValueError("transport must be 'rgb' or 'yuv420'")


def _input_shape_tail(crop: int, transport: str) -> tuple:
    """A frame's shape after the host preparation of
    ``BatchingInferenceServer.submit`` (downscale, then optional I420)."""
    if transport == "yuv420":
        return (crop * 3 // 2, crop)
    return (crop, crop, 3)


def _model_device(model) -> torch.device:
    if isinstance(model, torch.nn.Module):
        for t in list(model.parameters()) + list(model.buffers()):
            return t.device
    return torch.device("cuda")


def export_infer_artifact(
    forward_eval: Callable,
    model,
    *,
    crop: int = 224,
    transport: str = "rgb",
    compute_dtype=None,
    batch_size: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    class_names: Optional[Sequence[str]] = None,
    extra_meta: Optional[dict] = None,
    mesh=None,
) -> Tuple[Dict[str, bytes], dict]:
    """Export the fused serving program with ``model``'s weights in it.

    Returns ``(blobs, meta)``: ``{platform: torch.export.save bytes}`` and
    the artifact's metadata (JAX's keys, ``torch_version`` for
    ``jax_version``). ``batch_size=None`` exports a symbolic batch, an int
    pins it. ``platforms``: ``cuda`` (alias ``gpu``) and ``cpu``, one
    program each; default the model's device. ``mesh=`` is not ported
    yet."""
    if mesh is not None:
        raise NotImplementedError("mesh= (a sharded artifact) is not ported yet")
    home = _model_device(model)
    targets = _platforms(platforms, home)
    body = _fused_infer(forward_eval, crop=crop, transport=transport,
                        compute_dtype=compute_dtype)
    tail = _input_shape_tail(crop, transport)
    b = 2 if batch_size is None else int(batch_size)
    example = (torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (b,) + tail).astype(np.uint8)).to(home),)
    dynamic = None
    if batch_size is None:
        dynamic = (({0: torch.export.Dim("b", min=1)},),)  # forward(*inputs)
    ep, out = _export(lambda batch_u8: body(model, batch_u8), model, example, dynamic)
    blobs = {name: _serialize(_on(ep, home, dev)) for name, dev in targets}
    meta = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "crop": int(crop),
        "transport": transport,
        "batch_size": batch_size,
        "input_shape": ["b" if batch_size is None else int(batch_size), *tail],
        "num_outputs": int(np.prod(out.shape[1:])),
        "platforms": [name for name, _ in targets],
        "class_names": list(class_names) if class_names is not None else None,
        "compute_dtype": str(compute_dtype).replace("torch.", "") if compute_dtype else None,
        "n_devices": 1,
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)
    return blobs, meta


def _atomic_npz_write(path: str, **arrays) -> None:
    """Temp file and rename (as ``checkpoint/io.save_pytree_npz``), so a
    crash mid-write never leaves a torn artifact at ``path``."""
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".hst.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write(path: str, blobs: Dict[str, bytes], meta: dict) -> None:
    _atomic_npz_write(path, meta=np.asarray(json.dumps(meta)),
                      **{f"program_{k}": np.frombuffer(v, dtype=np.uint8)
                         for k, v in blobs.items()})


def save_infer_artifact(path: str, blobs: Dict[str, bytes], meta: dict) -> None:
    """One file: a ``program_<platform>`` entry a platform and the JSON
    metadata (an npz: the standard library and numpy read it), written
    atomically."""
    _write(path, blobs, meta)


def _read(path: str, fmt: str) -> Tuple[dict, Dict[str, bytes]]:
    """(meta, {key: program bytes}) of a port artifact of format ``fmt``;
    a JAX artifact, another format or another torch version raises."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"])) if "meta" in z.files else {}
        kind = meta.get("format")
        if kind in _JAX_FORMATS or any(n.startswith("stablehlo") for n in z.files):
            raise ValueError(
                f"{path} is a JAX StableHLO artifact (format {kind!r}), exported by the JAX "
                f"package; the PyTorch port serves {fmt} files (export one with the port's "
                "--export_artifact)")
        if kind != fmt:
            raise ValueError(f"{path} is not a {fmt} file")
        blobs = {n[len("program_"):]: z[n].tobytes() for n in z.files
                 if n.startswith("program_")}
    if meta.get("torch_version") != torch.__version__:
        raise RuntimeError(
            f"{path} was exported under torch {meta.get('torch_version')}; this host runs "
            f"torch {torch.__version__}: export it again here")
    return meta, blobs


def _load_device(device) -> torch.device:
    from ..core.device import resolve_device

    return resolve_device("cuda" if device is None else device)


class InferenceArtifact:
    """A loaded serving artifact: ``artifact(batch_u8) -> probs``.

    ``batch_u8`` is (B, crop, crop, 3) RGB for the ``rgb`` transport or
    (B, crop * 3 // 2, crop) planar I420 for ``yuv420``, the frames the
    batching server ships; it goes to ``device``. A symbolic-batch
    artifact takes any B, a static one only its own."""

    def __init__(self, exported, meta: dict, device: torch.device):
        self.meta = dict(meta)
        self.exported = exported
        self.device = device
        self._call = _module(exported)

    def __call__(self, batch_u8):
        with torch.inference_mode():
            return self._call(torch.as_tensor(batch_u8).to(self.device))

    def server_infer_fn(self) -> Callable:
        """``fn(model, batch_u8) -> probs`` for
        ``BatchingInferenceServer(infer_fn=...)``; the model is ignored
        (the weights are in the program)."""
        return lambda _model, batch_u8: self(batch_u8)


def _program_for(path: str, blobs: Dict[str, bytes], device: torch.device, key: str = ""):
    name = device.type + key
    if name not in blobs:
        have = sorted({k.split("_")[0] for k in blobs})
        raise ValueError(f"{path} holds no program for {device.type} (platforms {have}); "
                         f"export it with --export_platforms {device.type}")
    return _deserialize(blobs[name])


def load_infer_artifact(path: str, device=None) -> InferenceArtifact:
    """The artifact at ``path`` with its program for ``device`` (default
    ``cuda``: a host without a card raises; a file without a CUDA program
    raises rather than serving its CPU one)."""
    meta, blobs = _read(path, ARTIFACT_FORMAT)
    dev = _load_device(device)
    return InferenceArtifact(_program_for(path, blobs, dev), meta, dev)


# ------------------------------------------------------------------- style


def _style_examples(service, b: int) -> tuple:
    """(images_u8, style_w) of batch b on the service's device: random
    canvases and one-hot rows."""
    c, k = service.crop, max(1, len(service.style_names))
    images = torch.from_numpy(np.random.RandomState(b).randint(
        0, 256, (b, c, c, 3)).astype(np.uint8)).to(service.device)
    w = torch.zeros((b, k), dtype=torch.float32)
    w[:, 0] = 1.0
    return images, w.to(service.device)


def _export_step(loop, state: tuple, rest: tuple):
    """The loop's step ``(pixels, mu, nu, active, bc1, bc2, *rest) ->
    (pixels, mu, nu, active, per)`` as an ExportedProgram: ``make_fx`` on
    fake tensors (autograd runs below the tracer, so the graph holds the
    backward's ops), then ``torch.export`` of that graph."""
    import functools

    from torch.fx.experimental.proxy_tensor import make_fx

    from ..tasks.style_transfer import masked_adam_step

    step = functools.partial(masked_adam_step, loop.loss, loop.learning_rate, loop.threshold)
    example = state + tuple(rest)
    step(*example)  # eager once: the cached device constants are real tensors
    graph = make_fx(step, tracing_mode="fake", _allow_non_fake_inputs=True)(*example)
    ep, _ = _export(lambda *inputs: graph(*inputs), graph, example)
    return ep


def _export_loop(service, b: int) -> Dict[str, object]:
    """``prepare``, ``step`` and ``finish`` of the service's loop at batch b."""
    from ..tasks.style_service import job_noises
    from ..tasks.style_transfer import bias_corrections

    loop = service.loop
    images, w = _style_examples(service, b)
    noise = ((job_noises(loop.seed, range(b), (service.crop,) * 2 + (3,), service.device),)
             if loop.noise else ())
    prepare, prepared = _export(loop.prepare, None, (images, w) + noise)
    pixels0, *rest = prepared
    pixels = pixels0.detach().float().clone()
    state = (pixels, torch.zeros_like(pixels), torch.zeros_like(pixels),
             torch.ones((b,), dtype=torch.bool, device=pixels.device)) + bias_corrections(1)
    finish, _ = _export(loop.finish, None, (pixels,))
    return {"prepare": prepare, "step": _export_step(loop, state, tuple(rest)),
            "finish": finish}


def export_style_artifact(
    service,
    *,
    platforms: Optional[Sequence[str]] = None,
    extra_meta: Optional[dict] = None,
) -> Tuple[Dict[str, bytes], dict]:
    """Export a ``StyleTransferService``'s RGB jobs (whatever its
    transport), one entry a ladder size, with the model's weights and the
    encoded style gallery in the programs. A net job (``--net``) is one
    program ``(images_u8, style_w) -> (u8, per_loss)``; an iterative job is
    ``prepare``, ``step`` and ``finish`` (module docstring), its iteration
    cap, threshold, learning rate and noise seed in ``meta``. Returns
    ``(blobs, meta)`` with ``blobs`` keyed ``<platform>_<batch>_<program>``;
    write it with :func:`save_style_artifact`."""
    home = service.device
    targets = _platforms(platforms, home)
    mode = "net" if service.loop is None else "loop"
    blobs = {}
    for b in service.batch_sizes:
        if mode == "loop":
            programs = _export_loop(service, b)
        else:
            body = getattr(service._raw_jobs_by_size[b], "body", None)
            if body is None:
                raise ValueError("this service's job_fn has no exportable body "
                                 "(tasks/fast_style.make_net_job_fn gives one)")
            programs = {"job": _export(body, None, _style_examples(service, b))[0]}
        for name, dev in targets:
            for prog, ep in programs.items():
                blobs[f"{name}_{int(b)}_{prog}"] = _serialize(_on(ep, home, dev))
    meta = {
        "format": STYLE_ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "mode": mode,
        "crop": int(service.crop),
        "batch_size": int(service.batch_size),
        "batch_sizes": [int(b) for b in service.batch_sizes],
        "num_iterations": int(service.num_iterations),
        "style_names": list(service.style_names),
        "platforms": [name for name, _ in targets],
        "n_devices": 1,
        "torch_version": torch.__version__,
    }
    if mode == "loop":
        loop = service.loop
        meta.update(num_iterations=loop.num_iterations, threshold=loop.threshold,
                    learning_rate=loop.learning_rate, seed=loop.seed, noise=loop.noise)
    if extra_meta:
        meta.update(extra_meta)
    return blobs, meta


def save_style_artifact(path: str, blobs: Dict[str, bytes], meta: dict) -> None:
    """One file for the whole ladder: a ``program_<platform>_<batch>_<name>``
    entry a program and the JSON metadata, written atomically."""
    _write(path, blobs, meta)


class StyleArtifact:
    """A loaded style artifact: ``job_fns`` maps each exported batch size
    to its job ``(images_u8, style_w, job_ids) -> (u8, iters, per_loss)``
    for ``StyleTransferService(job_fn=artifact.job_fns,
    style_names=artifact.meta["style_names"], crop=...)``; ``job_fn`` is
    the largest size's. An iterative job is ``tasks/style_service.loop_job``
    over the exported prepare, step and finish."""

    def __init__(self, exported_by_size: Dict[int, Dict[str, object]], meta: dict,
                 device: torch.device):
        from ..tasks.style_service import loop_job

        self.meta = dict(meta)
        self.device = device
        self.exported_by_size = exported_by_size
        self.job_fns = {}
        for b, programs in exported_by_size.items():
            calls = {k: _module(ep) for k, ep in programs.items()}
            if meta["mode"] == "net":
                self.job_fns[b] = self._net_job(calls["job"])
            else:
                self.job_fns[b] = loop_job(
                    calls["prepare"], calls["step"], calls["finish"],
                    meta["seed"] if meta["noise"] else None, meta["num_iterations"],
                    meta["crop"], device)
        self.job_fn = self.job_fns[max(self.job_fns)]

    def _net_job(self, call) -> Callable:
        device = self.device

        def job(images_u8, style_w, job_ids):
            del job_ids
            with torch.inference_mode():
                out, per_loss = call(torch.as_tensor(images_u8).to(device),
                                     torch.as_tensor(style_w, dtype=torch.float32).to(device))
                return out, 1, per_loss

        return job

    def __call__(self, images_u8, style_w, job_ids):
        return self.job_fns[int(np.shape(images_u8)[0])](images_u8, style_w, job_ids)


def load_style_artifact(path: str, device=None) -> StyleArtifact:
    """The style artifact at ``path`` with its programs for ``device``
    (default ``cuda``, as :func:`load_infer_artifact`)."""
    meta, blobs = _read(path, STYLE_ARTIFACT_FORMAT)
    dev = _load_device(device)
    by_size = {int(b): {name: _program_for(path, blobs, dev, f"_{int(b)}_{name}")
                        for name in STYLE_PROGRAMS[meta["mode"]]}
               for b in meta["batch_sizes"]}
    return StyleArtifact(by_size, meta, dev)
