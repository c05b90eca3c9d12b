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

**Device count.** JAX seals an SPMD program over N devices into the file.
The port's servers hold one replica a device (``core.mesh.DeviceGroup``),
so an artifact exported with ``mesh=`` (a group of N) holds the per-device
program at B / N rows, with ``n_devices`` N and the global ``batch_size``
B (style: every ladder size) in ``meta`` under JAX's keys; a load with
``devices=`` builds one program a device of the group, and the batchers
split each batch over them. ``torch.export`` records the card a program
was traced on, in its state, its constants and the device arguments of
its factory calls: loading onto another card moves all of them there
(``_retarget``) and raises if any reference to another device is left,
so a program never runs on card 0 when another card was asked for.

The container is JAX's: an npz written atomically, a ``meta`` JSON and the
bytes of ``torch.export.save`` as uint8 arrays, one a platform (and for
style a platform, batch size and program). The formats are
``hst-infer-artifact-torch`` and ``hst-style-artifact-torch``: the JAX
loader refuses them, and this one refuses a JAX StableHLO file.
"""
from __future__ import annotations

import io
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def _devices_in(ep) -> set:
    """Every device an ExportedProgram refers to: its state's and its
    constants' tensors, and the ``torch.device`` arguments of its graph's
    nodes (a factory call's ``device=``, a ``to``)."""
    from torch.utils._pytree import tree_leaves

    found = {t.device for t in list(ep.state_dict.values()) + list(ep.constants.values())
             if torch.is_tensor(t)}
    for node in ep.graph_module.graph.nodes:
        for leaf in tree_leaves((node.args, node.kwargs)):
            if isinstance(leaf, torch.device):
                found.add(leaf)
    return found


def _stray_devices(ep, device: torch.device) -> list:
    """The devices ``ep`` refers to other than ``device``, as strings."""
    return sorted(str(d) for d in _devices_in(ep) if _concrete(d) != device)


def _concrete(device) -> torch.device:
    """``cuda`` -> ``cuda:<current card>`` (the card a bare ``cuda``
    means), ``cpu:0`` -> ``cpu``: one name a device."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _retarget(ep, device: torch.device):
    """``ep`` for ``device``: itself when it refers to no other device,
    else its state, constants and device arguments moved there
    (``move_to_device_pass``); a reference to another device that is left
    raises."""
    device = _concrete(device)
    if not _stray_devices(ep, device):
        return ep
    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(ep, device)
    stray = _stray_devices(ep, device)
    if stray:
        raise RuntimeError(f"the program still refers to {stray} after its move to {device}; "
                           "it would not run on that device alone")
    return ep


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
    program each; default the model's device. ``mesh``, a
    ``core.mesh.DeviceGroup`` of N, exports the per-device program at
    ``batch_size`` / N rows (a concrete batch that N divides), served by a
    load with ``devices=`` N devices (module docstring)."""
    n_dev = 1
    if mesh is not None:
        if batch_size is None:
            raise ValueError(
                "mesh-sharded export needs a concrete batch_size (a symbolic "
                "batch dimension cannot carry a sharding constraint)"
            )
        n_dev = mesh.size
        if int(batch_size) % n_dev:
            raise ValueError(f"batch_size {batch_size} is not divisible by the {n_dev} "
                             "devices of the mesh")
    home = _model_device(model)
    targets = _platforms(platforms, home)
    body = _fused_infer(forward_eval, crop=crop, transport=transport,
                        compute_dtype=compute_dtype)
    tail = _input_shape_tail(crop, transport)
    b = 2 if batch_size is None else int(batch_size) // n_dev
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
        "n_devices": n_dev,
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


def read_meta(path: str) -> dict:
    """The metadata of an artifact file, its programs left unread (the
    device count a server must build before it loads them)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"])) if "meta" in z.files else {}


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

    return _concrete(resolve_device("cuda" if device is None else device))


def _load_devices(meta: dict, device, devices) -> list:
    """One device a program: ``devices`` (as many as ``meta["n_devices"]``),
    else ``device`` for a one-device artifact."""
    n = int(meta.get("n_devices", 1))
    if devices is None:
        if n != 1:
            raise ValueError(f"this artifact holds the program of each of {n} devices; "
                             f"load it with devices= {n} devices")
        return [_load_device(device)]
    devices = [_load_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"this artifact was exported over {n} device(s); "
                         f"{len(devices)} given")
    return devices


class InferenceArtifact:
    """A loaded serving artifact: ``artifact(batch_u8) -> probs``.

    ``batch_u8`` is (B, crop, crop, 3) RGB for the ``rgb`` transport or
    (B, crop * 3 // 2, crop) planar I420 for ``yuv420``, the frames the
    batching server ships; it goes to ``device``. A symbolic-batch
    artifact takes any B, a static one only its own. An artifact of N
    devices holds a program a device (``programs``, each for B / N rows),
    served through ``server_infer_fns`` (the batcher splits the batch); a
    call then raises."""

    def __init__(self, exported, meta: dict, device: torch.device, programs=None):
        self.meta = dict(meta)
        self.exported = exported
        self.device = device
        # [(device, callable)], one a device of the artifact
        self.programs = programs or [(device, _module(exported))]
        self.devices = [d for d, _ in self.programs]

    def _run(self, k: int, batch_u8):
        device, call = self.programs[k]
        with torch.inference_mode():
            return call(torch.as_tensor(batch_u8).to(device))

    def __call__(self, batch_u8):
        if len(self.programs) > 1:
            raise ValueError(f"this artifact holds {len(self.programs)} devices' programs: "
                             "serve it through BatchingInferenceServer(infer_fn="
                             "server_infer_fns(), mesh=DeviceGroup(devices))")
        return self._run(0, batch_u8)

    def server_infer_fn(self) -> Callable:
        """``fn(model, batch_u8) -> probs`` for
        ``BatchingInferenceServer(infer_fn=...)``; the model is ignored
        (the weights are in the program)."""
        return lambda _model, batch_u8: self(batch_u8)

    def server_infer_fns(self) -> list:
        """One ``server_infer_fn`` a device of the artifact, for
        ``BatchingInferenceServer(infer_fn=..., mesh=DeviceGroup(
        artifact.devices))``: the batcher gives each its block."""
        return [(lambda _model, batch_u8, k=k: self._run(k, batch_u8))
                for k in range(len(self.programs))]


def _program_for(path: str, blobs: Dict[str, bytes], device: torch.device, key: str = ""):
    """The program of ``device``'s platform, on ``device`` (``_retarget``)."""
    name = device.type + key
    if name not in blobs:
        have = sorted({k.split("_")[0] for k in blobs})
        raise ValueError(f"{path} holds no program for {device.type} (platforms {have}); "
                         f"export it with --export_platforms {device.type}")
    return _retarget(_deserialize(blobs[name]), device)


def load_infer_artifact(path: str, device=None, devices=None) -> InferenceArtifact:
    """The artifact at ``path`` with its program for ``device`` (default
    ``cuda``: a host without a card raises; a file without a CUDA program
    raises rather than serving its CPU one). An artifact exported over N
    devices needs ``devices``, N of them (``core.mesh.DeviceGroup.devices``):
    one program each."""
    meta, blobs = _read(path, ARTIFACT_FORMAT)
    devs = _load_devices(meta, device, devices)
    exported = [_program_for(path, blobs, d) for d in devs]
    return InferenceArtifact(exported[0], meta, devs[0],
                             [(d, _module(ep)) for d, ep in zip(devs, exported)])


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
    encoded style gallery in the programs. A service of N replicas
    (``mesh=``) exports replica 0's programs at each size's B / N rows,
    ``n_devices`` N in ``meta``. A net job (``--net``) is one
    program ``(images_u8, style_w) -> (u8, per_loss)``; an iterative job is
    ``prepare``, ``step`` and ``finish`` (module docstring), its iteration
    cap, threshold, learning rate and noise seed in ``meta``. Returns
    ``(blobs, meta)`` with ``blobs`` keyed ``<platform>_<batch>_<program>``;
    write it with :func:`save_style_artifact`."""
    home = service.device
    targets = _platforms(platforms, home)
    mode = "net" if service.loop is None else "loop"
    n_dev = len(service.devices)
    blobs = {}
    for b in service.batch_sizes:
        if mode == "loop":
            programs = _export_loop(service, b // n_dev)
        else:
            job = service._raw_jobs_by_size[b]
            body = getattr(getattr(job, "replicas", [job])[0], "body", None)
            if body is None:
                raise ValueError("this service's job_fn has no exportable body "
                                 "(tasks/fast_style.make_net_job_fn gives one)")
            programs = {"job": _export(body, None, _style_examples(service, b // n_dev))[0]}
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
        "n_devices": n_dev,
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
    over the exported prepare, step and finish. An artifact of N devices
    holds such a mapping a device, ``replica_job_fns``, for
    ``StyleTransferService(job_fn=artifact.replica_job_fns,
    mesh=DeviceGroup(artifact.devices))``: the service splits each batch
    over them (``job_fns`` is then replica 0's, at B / N rows)."""

    def __init__(self, programs_by_device: List[Dict[int, Dict[str, object]]], meta: dict,
                 devices: List[torch.device]):
        from ..tasks.style_service import loop_job

        self.meta = dict(meta)
        self.devices = list(devices)
        self.device = self.devices[0]
        self.exported_by_size = programs_by_device[0]  # replica 0's programs
        seed = meta["seed"] if meta.get("noise") else None
        self.replica_job_fns = []
        for by_size, d in zip(programs_by_device, self.devices):
            jobs = {}
            for b, programs in by_size.items():
                c = {k: _module(ep) for k, ep in programs.items()}
                jobs[b] = (self._net_job(c["job"], d) if meta["mode"] == "net" else loop_job(
                    c["prepare"], c["step"], c["finish"], seed, meta["num_iterations"],
                    meta["crop"], d))
            self.replica_job_fns.append(jobs)
        self.job_fns = self.replica_job_fns[0]
        self.job_fn = self.job_fns[max(self.job_fns)]

    @staticmethod
    def _net_job(call, device) -> Callable:
        def job(images_u8, style_w, job_ids):
            del job_ids
            with torch.inference_mode():
                out, per_loss = call(torch.as_tensor(images_u8).to(device),
                                     torch.as_tensor(style_w, dtype=torch.float32).to(device))
                return out, 1, per_loss

        return job

    def __call__(self, images_u8, style_w, job_ids):
        if len(self.devices) > 1:
            raise ValueError(f"this artifact holds {len(self.devices)} devices' programs: "
                             "serve it through StyleTransferService(job_fn=replica_job_fns, "
                             "mesh=DeviceGroup(devices))")
        return self.job_fns[int(np.shape(images_u8)[0])](images_u8, style_w, job_ids)


def load_style_artifact(path: str, device=None, devices=None) -> StyleArtifact:
    """The style artifact at ``path`` with its programs for ``device``
    (default ``cuda``, as :func:`load_infer_artifact`); one of N devices
    needs ``devices``, N of them, and gets its programs once a device."""
    meta, blobs = _read(path, STYLE_ARTIFACT_FORMAT)
    devs = _load_devices(meta, device, devices)
    programs = [{int(b): {name: _program_for(path, blobs, d, f"_{int(b)}_{name}")
                          for name in STYLE_PROGRAMS[meta["mode"]]}
                 for b in meta["batch_sizes"]} for d in devs]
    return StyleArtifact(programs, meta, devs)
