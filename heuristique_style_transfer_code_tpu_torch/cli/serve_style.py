"""Serve style transfer over HTTP with job batching, on PyTorch — the flags
of ``heuristique_style_transfer_code_tpu/cli/serve_style.py`` plus
``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``).

Ported: ``--net`` (a feed-forward style net, one forward per job, its 15
instance norms through the hand-written kernel on the card), texture mode
(the Adam-on-pixels loop of family 2, or of family 3 with ``--family
multi_patchgan``; ``--model_path`` an ``.npz`` or a reference ``.pth``)
and content+style mode (``--style_image NAME=PATH``, repeatable, a gallery
that clients pick from or blend with ``X-Style``, with ``--style_weight``,
``--content_weight``, ``--tv_weight``, ``--style_init`` and
``--style_layers``), with ``--batch_size`` ladders, ``--precision
float32|bf16``, ``--transport rgb|yuv420``, ``--remat`` (family 2),
``--recycle_after_requests`` (the service in a spawned worker process,
``tasks/recycling.py``), ``--export_artifact`` (with
``--export_platforms``) and ``--artifact`` (``deploy/artifact.py``: the
service's programs, weights and style gallery in one file, served with no
model code, checkpoint or style images), ``--profile_dir``,
``--debug_nans`` and SIGTERM drain. ``--devices N`` serves one replica a
device in this one process (the first N cards, or N CPU replicas with
``--device cpu``; N clamped to the gcd of the ``--batch_size`` ladder, as
JAX's ``_sizes_gcd``), each job batch split over them; an artifact
exported under it seals N, and ``--artifact`` serves it on N devices. The
flags listed in ``_NOT_PORTED`` raise a "not ported yet" error.

    python -m heuristique_style_transfer_code_tpu_torch.cli.serve_style \\
        --net style_net.npz --batch_size 4,8 --port 8001 [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

from ._common import (
    add_device_args,
    artifact_group,
    check_ported,
    close_on_stop,
    count_params,
    export_group,
    load_checkpoint_tree,
    resolve_compute_dtype,
    resolve_serve_group,
    runtime_flags,
)

FAMILIES = ["gram_attention", "multi_patchgan"]

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED: dict = {}


def build_parser():
    parser = argparse.ArgumentParser(
        description="HTTP style-transfer job server with dynamic batching (PyTorch)")
    parser.add_argument("--family", choices=FAMILIES, default="gram_attention",
                        help="Texture mode's model family")
    parser.add_argument("--config_path", type=str, default=None,
                        help="Required unless --net is given")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Required unless --net is given")
    parser.add_argument("--artifact", type=str, default=None,
                        help="Serve from a style artifact (deploy/artifact.py): the service's "
                        "job programs with the weights and the style gallery in them, no "
                        "model code, checkpoint or style images on the serving host. Batch "
                        "sizes, crop, iterations and gallery come from its metadata (those "
                        "flags are ignored)")
    parser.add_argument("--export_artifact", type=str, default=None,
                        help="Write the style artifact of the configured service to this path "
                        "and exit (serve it later with --artifact)")
    parser.add_argument("--export_platforms", type=str, default=None,
                        help="Comma-separated platforms of --export_artifact's programs (cuda, "
                        "gpu, cpu); default: --device's")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8001,
                        help="0 picks a free port (printed at startup)")
    parser.add_argument("--batch_size", type=str, default="8",
                        help="Jobs per dispatch; a comma list ('4,8') serves several sizes "
                        "and each dispatch uses the smallest that fits the queued jobs")
    parser.add_argument("--transport", choices=["rgb", "yuv420"], default="rgb",
                        help="Pixel transport to and from the device: yuv420 ships planar "
                        "I420 both ways (half the bytes, 4:2:0 chroma); clients still send "
                        "and receive RGB")
    parser.add_argument("--max_delay_ms", type=float, default=200.0,
                        help="Flush deadline for a partially filled batch")
    parser.add_argument("--max_in_flight", type=int, default=2)
    parser.add_argument("--num_iterations", type=int, default=500)
    parser.add_argument("--threshold", type=float, default=1e-4)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--layers", type=int, default=None,
                        help="Family-2 encoder truncation, the reference's Sequential slice")
    parser.add_argument("--style_image", action="append", default=None, metavar="NAME=PATH",
                        help="Content+style mode (family gram_attention only): add a named "
                        "style image to the gallery (repeatable; a bare PATH names the style "
                        "after the file stem). The gallery is encoded once at startup; "
                        "clients pick a style per request with the X-Style header (GET "
                        "/styles lists names). Without this flag the server runs the "
                        "reference's texture-from-self loop.")
    parser.add_argument("--style_weight", type=float, default=1.0)
    parser.add_argument("--content_weight", type=float, default=1.0)
    parser.add_argument("--tv_weight", type=float, default=0.0)
    parser.add_argument("--style_init", choices=["content", "noise"], default="content",
                        help="Canvas initialisation for --style_image jobs")
    parser.add_argument("--style_layers", choices=["last", "all"], default="last",
                        help="Style Grams at the truncation point only, or at every executed "
                        "ResNet stage")
    parser.add_argument("--net", type=str, default=None,
                        help="Serve a trained feed-forward style network (style_net.npz): "
                        "each job is ONE forward pass; crop and the style names come from "
                        "its hyperparameters file")
    parser.add_argument("--remat", action="store_true",
                        help="Family 2: recompute each bottleneck's activations in the "
                        "backward instead of keeping them (less memory, the same pixels)")
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--max_seconds", type=float, default=None,
                        help="Exit after this many seconds (smoke tests)")
    parser.add_argument("--request_timeout", type=float, default=300.0,
                        help="Per-request wait on the job Future (s)")
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the kernel build and warm forward before binding the port")
    parser.add_argument("--recycle_after_requests", type=int, default=0,
                        help="Run the job service in a spawned worker process and respawn "
                        "it after this many requests (drained first: no request fails "
                        "across the handover); the worker's memory, host and device, goes "
                        "back with each respawn. This process keeps the HTTP server and "
                        "never initialises CUDA")
    add_device_args(parser)
    return parser


def _sizes(args):
    return [int(s) for s in str(args.batch_size).split(",") if s.strip()]


def _sizes_gcd(sizes):
    """The device count every ladder size divides (JAX ``:142-155``): a
    dispatch at any size splits its rows over the same replicas, so the
    usable count is bounded by the gcd of the sizes."""
    import math

    g = 0
    for s in sizes:
        g = math.gcd(g, int(s))
    return max(1, g)


def _group(args):
    """``--devices`` of the live service: None, or one replica a device."""
    return resolve_serve_group(args.devices, _sizes_gcd(_sizes(args)), args.device)


def _per_device(group, device, build):
    """``build(device)`` for one device, or one a replica of ``group``."""
    return build(device) if group is None else group.per_device(build)


def _build_net_service(args, device, crop: int, group=None):
    from ..checkpoint.io import load_hyperparameters, load_pytree_npz
    from ..nn.transformer_net import net_n_styles
    from ..tasks.fast_style import make_net_job_fn, net_from_tree
    from ..tasks.style_service import StyleTransferService

    tree = load_pytree_npz(args.net)
    net = net_from_tree(tree, device)
    hyper_path = args.net.replace(".npz", "_hyperparameters.json")
    hyper = load_hyperparameters(hyper_path) if os.path.exists(hyper_path) else {}
    net_crop = int(hyper.get("crop", crop))
    fallback = os.path.splitext(str(hyper.get("style_image", "style")))[0]
    style_names = [str(n) for n in hyper.get("style_names", [fallback])]
    n_styles = net_n_styles(net)
    if n_styles is not None and n_styles != len(style_names):
        raise SystemExit(f"--net has {n_styles} conditional styles but its "
                         f"hyperparameters name {len(style_names)}: {style_names}")
    kind = (f"conditional gallery {style_names}" if n_styles is not None
            else f"style {style_names[0]!r}")
    print(f"Feed-forward net: {kind}, crop {net_crop} (one forward per job)", flush=True)
    dtype = resolve_compute_dtype(args.precision)
    spare = [net]  # replica 0 takes the net loaded above, every other its own

    def job_on(d):
        return make_net_job_fn(spare.pop() if spare else net_from_tree(tree, d),
                               crop=net_crop, compute_dtype=dtype)

    jobs = _per_device(group, device, job_on)
    by_size = (lambda job: {s: job for s in _sizes(args)})  # noqa: E731
    return StyleTransferService(
        job_fn=by_size(jobs) if group is None else [by_size(j) for j in jobs],
        style_names=style_names,
        crop=net_crop,
        num_iterations=1,
        max_delay_ms=args.max_delay_ms,
        max_in_flight=args.max_in_flight,
        transport=args.transport,
        device=device,
        mesh=group,
    )


def _load_family2(args, device):
    """The family-2 model of ``--config_path`` and ``--model_path`` on
    ``device``, and its config."""
    from ..config.schema import GramAttentionConfig
    from .test_gram_attention import load_gram_attention

    cfg = GramAttentionConfig.from_json(args.config_path)
    tree = load_checkpoint_tree(args.model_path, "gram_attention", cfg.to_dict())
    if args.afficher_params:
        print(f"Nombre total de paramètres du modèle : {count_params(tree)}")
    model = load_gram_attention(args.model_path, cfg.truncate_layer, None,
                                cfg.gram_matrix_size, device, tree=tree)
    return model, cfg


def _build_gram_fn(args, device):
    """Texture mode's per-image Gram program of ``--family``, precision
    applied (JAX ``:155-195``, its ``--layers`` error word for word)."""
    dtype = resolve_compute_dtype(args.precision)
    if args.family == "gram_attention":
        from ..tasks.style_transfer import make_gram_fn_gram_attention

        model, cfg = _load_family2(args, device)
        return make_gram_fn_gram_attention(model, cfg.truncate_layer, layers=args.layers,
                                           compute_dtype=dtype, remat=args.remat)
    from ..checkpoint.convert import load_jax_tree
    from ..config.schema import MultiPatchGANConfig
    from ..models.multi_patchgan import SCALES, multiscale_test_init
    from ..tasks.style_transfer import make_gram_fn_patches

    if args.layers is not None:
        raise ValueError(
            "The reference's --layers truncation for PatchGAN style transfer "
            "is non-functional upstream (functions_Multi_PatchGAN.py:242); "
            "run without --layers."
        )
    cfg = MultiPatchGANConfig.from_json(args.config_path)
    tree = load_checkpoint_tree(args.model_path, "multi_patchgan", cfg.to_dict())
    if args.afficher_params:
        print(f"Nombre total de paramètres du modèle : {count_params(tree)}")
    # the test variant, its class count the checkpoint's (the Gram reads
    # the embedding only)
    num_classes = int(np.shape(tree[SCALES[0]]["classifier"]["kernel"])[-1])
    model = load_jax_tree(
        multiscale_test_init(None, cfg.patch_sizes, ndf=cfg.ndf, num_classes=num_classes,
                             gram_matrix_dim=cfg.gram_matrix_dim, norm=cfg.norm, device=device),
        tree)
    return make_gram_fn_patches(model, cfg.gram_matrix_dim, norm=cfg.norm, compute_dtype=dtype)


def _build_content_style_kwargs(args, device):
    """Service kwargs of ``--style_image`` mode: the family-2 extraction
    program and the named style gallery (the JAX CLI's checks and
    messages)."""
    if args.family != "gram_attention":
        raise ValueError("--style_image requires --family gram_attention")
    from ..data.loader import load_image_staged
    from ..tasks.style_transfer import make_extract_fn_gram_attention

    model, cfg = _load_family2(args, device)
    extract_fn = make_extract_fn_gram_attention(
        model, cfg.truncate_layer, layers=args.layers,
        compute_dtype=resolve_compute_dtype(args.precision), style_layers=args.style_layers,
        remat=args.remat)
    styles = {}
    for spec in args.style_image:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        if name in styles:
            raise ValueError(f"duplicate style name {name!r}")
        styles[name] = load_image_staged(path)
    return dict(extract_fn=extract_fn, styles=styles, style_weight=args.style_weight,
                content_weight=args.content_weight, tv_weight=args.tv_weight,
                init=args.style_init)


def build_service(args, crop: int = 224):
    """The configured (unstarted) StyleTransferService on ``--device``."""
    from ..core.device import resolve_device
    from ..tasks.style_service import StyleTransferService

    check_ported(args, _NOT_PORTED)
    resolve_compute_dtype(args.precision)
    device = resolve_device(args.device)
    if args.artifact and not args.net:  # --net first, as in the JAX CLI
        return _artifact_service(args, device)
    group = _group(args)
    if group is not None:
        device = group.devices[0]
    if args.net:
        return _build_net_service(args, device, crop, group)
    if not args.config_path or not args.model_path:
        raise SystemExit("--config_path and --model_path are required unless --artifact "
                         "or --net is given")
    if args.style_image:
        built = _per_device(group, device, lambda d: _build_content_style_kwargs(args, d))
        kwargs = built if group is None else {
            **built[0], "extract_fn": [k["extract_fn"] for k in built]}
    else:
        kwargs = dict(gram_fn=_per_device(group, device, lambda d: _build_gram_fn(args, d)))
    sizes = _sizes(args)
    return StyleTransferService(
        crop=crop,
        **kwargs,
        batch_size=sizes if len(sizes) > 1 else sizes[0],
        max_delay_ms=args.max_delay_ms,
        num_iterations=args.num_iterations,
        threshold=args.threshold,
        learning_rate=args.lr,
        max_in_flight=args.max_in_flight,
        seed=0,
        transport=args.transport,
        device=device,
        mesh=group,
    )


def _artifact_service(args, device):
    """The service of ``--artifact``: its programs on ``device``, or on as
    many devices as it seals (``_common.artifact_group``), one replica a
    device."""
    from ..deploy.artifact import load_style_artifact
    from ..tasks.style_service import StyleTransferService

    group = artifact_group(args, args.artifact)
    art = load_style_artifact(args.artifact, device=device,
                              devices=group.devices if group is not None else None)
    meta = art.meta
    sizes = sorted(art.job_fns)
    print(f"Artifact: batch sizes {sizes}, crop {meta['crop']}, "
          f"{meta['num_iterations']} iters, gallery {meta['style_names']}, "
          f"platforms {meta['platforms']}", flush=True)
    # one program (or loop) a size: the dispatcher picks the smallest
    # that fits, as live serving does
    return StyleTransferService(
        job_fn=art.job_fns if group is None else art.replica_job_fns,
        style_names=meta["style_names"],
        crop=meta["crop"],
        num_iterations=meta["num_iterations"],
        max_delay_ms=args.max_delay_ms,
        max_in_flight=args.max_in_flight,
        transport=args.transport,
        device=art.device,
        mesh=group,
    )


def export_artifact(args) -> None:
    """--export_artifact: export the job programs the server would dispatch
    (the service ``build_service`` makes) and write them; exits without
    serving (JAX
    ``:342-360``)."""
    from ..deploy.artifact import export_style_artifact, save_style_artifact

    if not args.artifact:  # the JAX CLI's checks of serve --export_artifact
        export_group(args, _sizes_gcd(_sizes(args)), f"--batch_size {args.batch_size}")
    service = build_service(args)
    platforms = ([p.strip() for p in args.export_platforms.split(",") if p.strip()]
                 if args.export_platforms else None)
    blobs, meta = export_style_artifact(service, platforms=platforms)
    save_style_artifact(args.export_artifact, blobs, meta)
    total = sum(len(b) for b in blobs.values())
    print(f"Style artifact written to {args.export_artifact} ({total / 1e6:.1f} MB of "
          f"programs, batch sizes {meta['batch_sizes']}, platforms {meta['platforms']})")


def _start_service(args, crop: int = 224):
    """The configured service, started and (unless --no_warmup) warmed."""
    service = build_service(args, crop=crop).start()
    if not args.no_warmup:
        print("Warming up (kernel build, warm forward)...", flush=True)
        t0 = time.time()
        service.warmup()
        print(f"Warmup done in {time.time() - t0:.1f}s")
    return service


def start(args, crop: int = 224):
    """Build the service and the HTTP server and start the service (returns
    (srv, service); used by main() and callable from tests)."""
    from ..tasks.style_http import make_style_http_server

    service = _start_service(args, crop=crop)
    srv = make_style_http_server(service, args.host, args.port, timeout_s=args.request_timeout)
    return srv, service


def _recycle_worker(argv):
    """Builder run inside the recycling worker child (``tasks/recycling.py``;
    JAX ``:380-401``): the configured style service from the serve argv,
    under ``--profile_dir`` and ``--debug_nans`` until it stops."""
    args = build_parser().parse_args(argv)
    flags = contextlib.ExitStack()
    flags.enter_context(runtime_flags(args))
    try:
        service = _start_service(args)
    except BaseException:
        flags.close()
        raise
    close_on_stop(service, flags)
    info = {
        "crop": service.crop,
        "transport": service.transport,
        "style_names": list(service.style_names),
        "batch_sizes": list(service.batch_sizes),
        "num_iterations": service.num_iterations,
        "count_key": "jobs",
        "max_queue": service.max_queue,
        "device": str(service.device),
    }
    return service, info


def _recycle_preprocess(info):
    """The recycling proxy's submit preprocessing, in the HTTP request
    thread (JAX ``:404-422``): the canvas validation and downscale and the
    style-pick validation of ``StyleTransferService.submit`` (bad requests
    still answer 400 at once)."""
    crop = int(info["crop"])
    names = list(info["style_names"])

    def prep(image, style=None):
        from ..tasks.style_service import _to_canvas, style_weights

        image = _to_canvas(image, crop)
        if names:
            style_weights(style, names)  # validated only; the worker computes them again
        elif style is not None:
            raise ValueError("texture mode takes no style= (no gallery)")
        return (image,), {"style": style}

    return prep


def start_recycling(args, argv):
    """--recycle_after_requests: the job service lives in a spawned worker
    process (drained and respawned after N requests); this process keeps
    the HTTP server and never touches the card. Returns (srv, proxy), the
    surface of ``start``."""
    from ..tasks.recycling import RecyclingServiceProxy, strip_flag
    from ..tasks.style_http import make_style_http_server

    check_ported(args, _NOT_PORTED)
    proxy = RecyclingServiceProxy(
        "heuristique_style_transfer_code_tpu_torch.cli.serve_style:_recycle_worker",
        strip_flag(list(argv), "--recycle_after_requests"),
        recycle_after=args.recycle_after_requests,
        preprocess_factory=_recycle_preprocess,
    ).start()
    srv = make_style_http_server(proxy, args.host, args.port, timeout_s=args.request_timeout)
    return srv, proxy


def main(argv=None):
    import signal
    import sys
    import threading

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.export_artifact:
        with runtime_flags(args):
            export_artifact(args)
        return
    # SIGTERM = orchestrated shutdown: stop accepting, drain submitted jobs,
    # exit — registered before the warmup so a signal landing then still
    # shuts down cleanly; the previous handler comes back on return
    stop_requested = threading.Event()
    try:
        previous = signal.signal(signal.SIGTERM, lambda signum, frame: stop_requested.set())
    except ValueError:
        previous = None  # not the main thread (programmatic use)
    try:
        if args.recycle_after_requests:
            # --profile_dir and --debug_nans act in the worker
            _serve(args, stop_requested, *start_recycling(args, raw_argv))
        else:
            with runtime_flags(args):
                _serve(args, stop_requested, *start(args))
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _serve(args, stop_requested, srv, service) -> None:
    import threading

    host, port = srv.server_address[:2]
    batch_str = ",".join(str(s) for s in service.batch_sizes)
    print(f"Serving style transfer on http://{host}:{port} "
          f"(batch {batch_str}, {service.num_iterations} iters, {args.precision}, "
          f"{service.device})", flush=True)
    if service.style_names:
        print(f"Style gallery: {service.style_names}", flush=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        t0 = time.time()
        while args.max_seconds is None or time.time() - t0 < args.max_seconds:
            if stop_requested.is_set():
                print("SIGTERM: draining and shutting down")
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        service.stop(drain=True)
        stats = service.stats()
        print(f"Stats: {stats['jobs']} jobs in {stats['batches']} batches "
              f"(mean occupancy {stats['mean_batch_occupancy']:.2f}, "
              f"mean iterations {stats['mean_iterations']:.0f})")


if __name__ == "__main__":
    main()
