"""Serve a trained checkpoint over HTTP with dynamic batching, on PyTorch —
the flags of ``heuristique_style_transfer_code_tpu/cli/serve.py`` plus
``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``).

Concurrent clients POST images to /predict; the batcher
(``tasks/serving.py``) packs them into one static-shape batch a dispatch.
Ported: the three families (``--model_path`` an ``.npz`` or a reference
``.pth``), ``--precision float32|bf16|int8`` (int8 for families 1 and 2:
``--calib_data``, ``--quantized_path``), ``--transport rgb|yuv420``,
``--recycle_after_requests`` (the batcher in a spawned worker process,
``tasks/recycling.py``), ``--export_artifact`` (with ``--export_batch``
and ``--export_platforms``) and ``--artifact`` (``deploy/artifact.py``:
one ``torch.export`` file, served with no config or checkpoint),
``--profile_dir``, ``--debug_nans``, the warmup (which on the card also
builds the kernels and makes cuDNN's first choices before the port binds)
and the SIGTERM drain. The flags listed in ``_NOT_PORTED`` raise a "not
ported yet" error.

    python -m heuristique_style_transfer_code_tpu_torch.cli.serve \\
        --family truncated_resnet50 --config_path cfg.json \\
        --model_path models/best_global_model.npz --port 8000 \\
        --batch_size 64 --max_delay_ms 10 --precision bf16 [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np

from ._common import (
    add_device_args,
    check_ported,
    close_on_stop,
    count_params,
    load_checkpoint_tree,
    resolve_class_names,
    resolve_compute_dtype,
    runtime_flags,
)

FAMILIES = ["truncated_resnet50", "gram_attention", "multi_patchgan"]

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED = {
    "devices": None,
}


def build_parser():
    parser = argparse.ArgumentParser(
        description="HTTP inference server with dynamic batching (PyTorch)")
    parser.add_argument("--family", choices=FAMILIES, default="truncated_resnet50")
    parser.add_argument("--config_path", type=str, help="Required unless --artifact is given")
    parser.add_argument("--model_path", type=str, help="Required unless --artifact is given")
    parser.add_argument("--artifact", type=str, default=None,
                        help="Serve from an artifact (deploy/artifact.py): the fused program "
                        "and its weights as one torch.export file, no model code, config or "
                        "checkpoint needed (transport, crop and classes come from its "
                        "metadata; the precision is baked in)")
    parser.add_argument("--export_artifact", type=str, default=None,
                        help="Export the serving program (with the current --precision and "
                        "--transport) to this path and exit instead of serving")
    parser.add_argument("--export_batch", type=str, default="any",
                        help="Batch size baked into the exported artifact; 'any' (default) "
                        "exports a symbolic batch dimension valid for every batch size")
    parser.add_argument("--export_platforms", type=str, default=None,
                        help="Comma-separated platforms of the artifact's programs (cuda, "
                        "gpu, cpu; e.g. 'cuda,cpu' for one file served on the card and "
                        "checked on a CPU host); default: --device's")
    parser.add_argument("--classes", nargs="+", type=str)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="0 picks a free port (printed at startup)")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--max_delay_ms", type=float, default=10.0)
    parser.add_argument("--max_in_flight", type=int, default=3)
    parser.add_argument("--transport", choices=["rgb", "yuv420"], default="rgb",
                        help="Host->device frame format; yuv420 packs each frame to planar "
                        "I420 in the client's thread and halves the bytes uploaded")
    parser.add_argument("--calib_data", type=str, default=None,
                        help="ImageFolder root calibrating the int8 encoder — its train/ "
                        "split when present, else test/ (required with --precision int8 "
                        "unless --quantized_path points at an existing quantised tree)")
    parser.add_argument("--quantized_path", type=str, default=None,
                        help="Persisted quantised-encoder npz: loaded if present (a cold "
                        "start skips calibration), else written after calibration")
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--max_seconds", type=float, default=None,
                        help="Exit after this many seconds (smoke tests)")
    parser.add_argument("--request_timeout", type=float, default=30.0,
                        help="Per-request wait on the batcher Future (s)")
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the warm dispatch before binding the port (the first "
                        "requests then pay the kernel build and cuDNN's first choices)")
    parser.add_argument("--recycle_after_requests", type=int, default=0,
                        help="Run the batcher in a spawned worker process and respawn it "
                        "after this many requests (drained first: no request fails across "
                        "the handover); the worker's memory, host and device, goes back "
                        "with each respawn. This process keeps the HTTP server and never "
                        "initialises CUDA")
    add_device_args(parser, precisions=("float32", "bf16", "int8"))
    return parser


def _build_forward(family: str, config_path: str, model_path: str, device="cuda"):
    """(forward_eval, model, config dict) of ``family`` on ``device``, the
    model loaded through the port's loaders (JAX ``:109-164``)."""
    from ..core.device import resolve_device

    device = resolve_device(device)
    if family == "truncated_resnet50":
        from ..config.schema import TruncatedResNetConfig
        from ..models.truncated_resnet50 import combined_apply
        from ._common import load_truncated_resnet50

        cfg = TruncatedResNetConfig.from_json(config_path)
        tree = load_checkpoint_tree(model_path, family, cfg.to_dict())
        # a moco-only checkpoint (a pretrain-phase .pth) has no classifier:
        # fail here with the JAX CLI's message
        if "moco" not in tree or "classifier" not in tree:
            raise KeyError(
                f"Checkpoint {model_path} does not contain the family-1 "
                "{'moco', 'classifier'} tree — classifier weights not "
                "found in checkpoint."
            )
        t = cfg.truncate_layer
        model = load_truncated_resnet50(model_path, t, device, tree=tree)

        def forward_eval(m, images):
            return combined_apply(m.moco, m.classifier, images, t)

        return forward_eval, model, cfg.to_dict()
    if family == "gram_attention":
        from ..config.schema import GramAttentionConfig
        from ..models.gram_attention import gram_attention_apply
        from .test_gram_attention import load_gram_attention

        cfg = GramAttentionConfig.from_json(config_path)
        config = cfg.to_dict()
        num_classes = int(config.get("num_classes", 4))
        t, s = cfg.truncate_layer, cfg.gram_matrix_size
        tree = load_checkpoint_tree(model_path, family, config)
        model = load_gram_attention(model_path, t, num_classes, s, device, tree=tree)

        def forward_eval(m, images):
            return gram_attention_apply(m, images, t, s, num_classes)[1]

        return forward_eval, model, config
    # multi_patchgan: the train variant in eval mode, as the JAX CLI serves it
    from ..checkpoint.convert import load_jax_tree
    from ..config.schema import MultiPatchGANConfig
    from ..models.multi_patchgan import SCALES, multiscale_apply, multiscale_init

    cfg = MultiPatchGANConfig.from_json(config_path)
    config = cfg.to_dict()
    tree = load_checkpoint_tree(model_path, family, config)
    num_classes = int(np.shape(tree[SCALES[0]]["out_conv"]["kernel"])[-1])
    model = load_jax_tree(
        multiscale_init(None, cfg.patch_sizes, ndf=cfg.ndf, num_classes=num_classes,
                        norm=cfg.norm, device=device),
        tree)
    norm = cfg.norm

    def forward_eval(m, images):
        return multiscale_apply(m, images, norm=norm)

    return forward_eval, model, config


def _resolve_forward(args):
    """(forward_eval, model, config, class_names) with the precision path
    (bf16 cast, int8 PTQ) applied (JAX ``:167-224``)."""
    if not args.config_path or not args.model_path:
        raise ValueError("--config_path and --model_path are required "
                         "unless --artifact is given")
    forward_eval, model, config = _build_forward(args.family, args.config_path,
                                                 args.model_path, args.device)
    class_names = resolve_class_names(args.classes, config, None)
    if args.afficher_params:
        from ..checkpoint.convert import to_jax_tree

        print(f"Nombre total de paramètres du modèle : {count_params(to_jax_tree(model))}")
    if args.precision == "int8":
        if args.family not in ("truncated_resnet50", "gram_attention"):
            raise ValueError("--precision int8 is served for the "
                             "truncated_resnet50 and gram_attention families")
        from ._common import collect_calibration_batches, make_calibration_loader

        cal = None
        if not (args.quantized_path and os.path.exists(args.quantized_path)):
            if not args.calib_data:
                raise ValueError("--precision int8 requires --calib_data "
                                 "(or an existing --quantized_path)")
            cal = collect_calibration_batches(make_calibration_loader(args, args.batch_size),
                                              device=next(model.parameters()).device)
        truncate = int(config.get("truncate_layer", 8))
        if args.family == "gram_attention":
            from ._common import build_int8_family2

            apply_eval, model = build_int8_family2(
                model, truncate, int(config.get("gram_matrix_size", 7)),
                int(config.get("num_classes", 4)), cal, quantized_path=args.quantized_path)

            def forward_eval(m, images):  # noqa: F811
                return apply_eval(m, images)[1]

        else:
            from ._common import build_int8_family1

            forward_eval, _, model = build_int8_family1(  # noqa: F811
                model, truncate, cal, quantized_path=args.quantized_path)
    else:
        from ._common import cast_forward

        forward_eval = cast_forward(forward_eval, resolve_compute_dtype(args.precision))
    return forward_eval, model, config, class_names


def export_artifact(args) -> None:
    """--export_artifact: export the exact serving program (the precision
    and transport of ``start``) and write one deployable file (JAX
    ``:227-275`` without the mesh)."""
    from ..deploy import export_infer_artifact, save_infer_artifact

    check_ported(args, _NOT_PORTED)
    forward_eval, model, _, class_names = _resolve_forward(args)
    batch = None if args.export_batch == "any" else int(args.export_batch)
    platforms = ([p.strip() for p in args.export_platforms.split(",") if p.strip()]
                 if args.export_platforms else None)
    blobs, meta = export_infer_artifact(
        forward_eval, model, transport=args.transport, batch_size=batch, platforms=platforms,
        class_names=class_names, extra_meta={"family": args.family, "precision": args.precision})
    save_infer_artifact(args.export_artifact, blobs, meta)
    print(f"Artifact exported to {args.export_artifact} (platforms {meta['platforms']}, batch "
          f"{'symbolic' if batch is None else batch}, "
          f"{sum(len(b) for b in blobs.values()) / 1e6:.1f} MB)")


def _build_batcher(args):
    """Build, start and (unless --no_warmup) warm the batcher: everything
    on the device, shared by ``start`` and ``_recycle_worker`` (JAX
    ``:278-364``). Returns (batcher, class_names, batch_size, served)."""
    from ..tasks.serving import BatchingInferenceServer

    check_ported(args, _NOT_PORTED)
    if args.artifact:
        from ..deploy import load_infer_artifact

        art = load_infer_artifact(args.artifact, device=args.device)
        meta = art.meta
        if meta["batch_size"] is not None and meta["batch_size"] != args.batch_size:
            print(f"Note: artifact pins batch_size={meta['batch_size']} "
                  f"(overriding --batch_size {args.batch_size})")
        batch_size = meta["batch_size"] or args.batch_size
        if meta["transport"] != args.transport:
            print(f"Note: artifact transport is '{meta['transport']}' "
                  f"(overriding --transport {args.transport})")
        class_names = resolve_class_names(
            args.classes, {"classes": meta["class_names"]} if meta.get("class_names") else {},
            None)
        batcher = BatchingInferenceServer(
            None, None,
            batch_size=batch_size,
            max_delay_ms=args.max_delay_ms,
            max_in_flight=args.max_in_flight,
            transport=meta["transport"],
            crop=meta["crop"],
            infer_fn=art.server_infer_fn(),
            device=art.device,
        ).start()
        served = f"artifact {args.artifact} [{meta.get('family', 'unknown')}]"
    else:
        forward_eval, model, _, class_names = _resolve_forward(args)
        batch_size, served = args.batch_size, args.family
        batcher = BatchingInferenceServer(
            forward_eval, model,
            batch_size=args.batch_size,
            max_delay_ms=args.max_delay_ms,
            max_in_flight=args.max_in_flight,
            transport=args.transport,
        ).start()
    if not args.no_warmup:
        # the kernels' build and cuDNN's first choices are paid before the
        # port opens, so no live request times out on them
        print("Warming up (kernel build, warm forward)...", flush=True)
        t0 = time.time()
        warm = np.zeros((batcher.crop, batcher.crop, 3), dtype=np.uint8)
        warm[::2, ::2] = 128  # not constant
        batcher.submit(warm).result()
        print(f"Warmup done in {time.time() - t0:.1f}s")
    return batcher, class_names, batch_size, served


def _recycle_worker(argv):
    """Builder run inside the recycling worker child (``tasks/recycling.py``):
    the configured batcher from the serve argv, under ``--profile_dir`` and
    ``--debug_nans`` until it stops."""
    args = build_parser().parse_args(argv)
    flags = contextlib.ExitStack()
    flags.enter_context(runtime_flags(args))
    try:
        batcher, class_names, batch_size, served = _build_batcher(args)
    except BaseException:
        flags.close()
        raise
    close_on_stop(batcher, flags)
    info = {
        "crop": batcher.crop,
        "transport": batcher.transport,
        "class_names": class_names,
        "batch_size": batch_size,
        "served": served,
        "count_key": "images",
        "max_queue": batcher.max_queue,
        "device": str(batcher.device),
    }
    return batcher, info


def _recycle_preprocess(info):
    """The recycling proxy's submit preprocessing, in the HTTP request
    thread: the validation and downscale of ``BatchingInferenceServer.
    submit`` (bad frames still answer 400 at once)."""
    crop = int(info["crop"])

    def prep(frame):
        from ..tasks.serving import prepare_frame

        return (prepare_frame(frame, crop),), {}

    return prep


def start_recycling(args, argv):
    """--recycle_after_requests: the batcher lives in a spawned worker
    process (drained and respawned after N requests); this process keeps
    the HTTP server and never touches the card. Returns (srv, proxy), the
    surface of ``start``."""
    import threading

    from ..tasks.recycling import RecyclingServiceProxy, strip_flag
    from ..tasks.serving_http import make_http_server

    check_ported(args, _NOT_PORTED)
    proxy = RecyclingServiceProxy(
        "heuristique_style_transfer_code_tpu_torch.cli.serve:_recycle_worker",
        strip_flag(list(argv), "--recycle_after_requests"),
        recycle_after=args.recycle_after_requests,
        preprocess_factory=_recycle_preprocess,
    ).start()
    srv = make_http_server(proxy, proxy.info["class_names"], args.host, args.port,
                           timeout_s=args.request_timeout)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address
    print(f"Serving {proxy.info['served']} on http://{host}:{port} "
          f"(batch {proxy.info['batch_size']}, deadline {args.max_delay_ms} ms, "
          f"{proxy.info['device']}, worker recycled every {args.recycle_after_requests} "
          "requests)", flush=True)
    return srv, proxy


def start(args):
    """Build the batcher and the HTTP server and start both (returns (srv,
    batcher); used by main() and callable from tests)."""
    import threading

    from ..tasks.serving_http import make_http_server

    batcher, class_names, batch_size, served = _build_batcher(args)
    srv = make_http_server(batcher, class_names, args.host, args.port,
                           timeout_s=args.request_timeout)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address
    print(f"Serving {served} on http://{host}:{port} "
          f"(batch {batch_size}, deadline {args.max_delay_ms} ms, {batcher.device})",
          flush=True)
    return srv, batcher


def main(argv=None):
    import signal
    import sys
    import threading

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(raw_argv)
    if args.export_artifact:
        if args.artifact:
            raise ValueError("--export_artifact and --artifact are exclusive")
        with runtime_flags(args):
            export_artifact(args)
        return
    if args.artifact and args.precision != "float32":
        raise ValueError("--precision is baked into the artifact at export "
                         "time; do not pass it with --artifact")
    # SIGTERM = orchestrated shutdown: stop accepting, drain everything
    # submitted, exit; registered before the warmup so a signal landing then
    # still shuts down cleanly; the previous handler comes back on return
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


def _serve(args, stop_requested, srv, batcher) -> None:
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
        batcher.stop(drain=True)
        stats = batcher.stats()
        print(f"Stats: {stats['images']} images in {stats['batches']} batches "
              f"(mean occupancy {stats['mean_batch_occupancy']:.2f})", flush=True)


if __name__ == "__main__":
    main()
