"""Realtime camera and video inference (``tasks/camera.py`` of the JAX
package).

Per frame the device does the whole compute: uint8 frame -> /255 ->
(PIL-parity resize of the shorter side to 256 and center crop 224, unless
the host downscaled it) -> ImageNet normalisation -> model forward ->
softmax in f32. The host grabs frames, draws overlays and ships one uint8
frame (RGB, planar I420, or an I420 temporal delta) per step. OpenCV is
imported only where a frame is grabbed, converted or resized.

Each ``make_camera_infer_fn*`` returns ``infer(model, frame, ...)``: the
frame (a numpy array or a tensor) goes to the model's device; the
probabilities come back as a device tensor, which the caller fetches (the
fetch is the step's synchronisation).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import device_of
from ..core.geometry import center_crop_offsets, resize_target
from ..ops.resize import center_crop, normalize_imagenet, resize_shorter_side


def _to_device(frame, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(frame).to(device)


def _classify(forward_eval: Callable, model, x: torch.Tensor, compute_dtype,
              single: bool) -> torch.Tensor:
    """Normalised float NHWC (or HWC when ``single``) -> softmax in f32."""
    if single:
        x = x[None]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    logits = forward_eval(model, x.contiguous())
    probs = torch.softmax(logits.float(), dim=-1)
    return probs[0] if single else probs


def camera_body(
    forward_eval: Callable,
    compute_dtype: Optional[torch.dtype] = None,
    batch: Optional[int] = None,
    host_downscale: bool = False,
):
    """The tensor program of ``make_camera_infer_fn``: ``body(model,
    frame_u8)`` with the frame already on the model's device, no grad mode
    of its own. The infer function and ``deploy/artifact.py``'s export run
    this same function, so an exported program is the served one."""

    def body(model, frame_u8):
        x = frame_u8.to(torch.float32) / 255.0
        if not host_downscale:
            x = resize_shorter_side(x, 256)
            x = center_crop(x, 224)
        x = normalize_imagenet(x)
        return _classify(forward_eval, model, x, compute_dtype, batch is None)

    return body


def make_camera_infer_fn(
    forward_eval: Callable,
    compute_dtype: Optional[torch.dtype] = None,
    batch: Optional[int] = None,
    host_downscale: bool = False,
):
    """Returns ``infer(model, frame_u8)``: an (H, W, 3) frame, or
    (B, H, W, 3) with ``batch``, -> probabilities. ``host_downscale``: the
    frame arrives already resized and cropped to 224² (``downscale_frame``),
    so the device only normalises it."""
    body = camera_body(forward_eval, compute_dtype, batch, host_downscale)

    @torch.inference_mode()
    def infer(model, frame_u8):
        return body(model, _to_device(frame_u8, device_of(model)))

    return infer


def rgb_to_yuv420(rgb: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) uint8 -> planar I420 (H*3//2, W) uint8 by cv2
    (BT.601): half the bytes of RGB."""
    import cv2

    return cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)


def rgb_to_yuv420_device(rgb_u8: torch.Tensor) -> torch.Tensor:
    """RGB (..., H, W, 3) uint8 -> planar I420 (..., H*3//2, W) uint8 on
    the tensor's device (JAX ``:76-97``): BT.601 studio swing, the
    convention of cv2's ``COLOR_RGB2YUV_I420`` and of
    ``yuv420_to_rgb_device``, so the result decodes with cv2's
    ``COLOR_YUV2RGB_I420``; chroma the mean of each 2x2 block; rounded
    (half to even) and clipped. Leading dimensions are frames; H and W
    even, and W a multiple of 4 where H // 4 chroma rows must hold a
    plane. The style service packs its results with it."""
    lead, (h, w) = rgb_u8.shape[:-3], rgb_u8.shape[-3:-1]
    rgbf = rgb_u8.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    y = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * b
    u = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * b
    v = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * b

    def subsample(p):  # (..., H, W) -> (..., H//4, W): the 2x2 means, row-packed
        return p.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1)).reshape(*lead,
                                                                                 h // 4, w)

    packed = torch.cat([y, subsample(u), subsample(v)], dim=-2)
    return torch.clamp(torch.round(packed), 0.0, 255.0).to(torch.uint8)


def yuv420_to_rgb_device(yuv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Planar I420 (..., H*3//2, W) uint8 -> float RGB (..., H, W, 3) in
    [0, 1], BT.601 studio swing (Y in [16, 235]), the convention of cv2's
    ``COLOR_RGB2YUV_I420``; leading dimensions are frames."""
    lead = yuv.shape[:-2]
    y = yuv[..., :h, :].to(torch.float32)
    u_plane = yuv[..., h : h + h // 4, :].reshape(*lead, h // 2, w // 2)
    v_plane = yuv[..., h + h // 4 :, :].reshape(*lead, h // 2, w // 2)

    def upsample(p):
        p = torch.repeat_interleave(p, 2, dim=-2)
        return torch.repeat_interleave(p, 2, dim=-1).to(torch.float32)

    c = 1.164 * (y - 16.0)
    d = upsample(u_plane) - 128.0
    e = upsample(v_plane) - 128.0
    r = c + 1.596 * e
    g = c - 0.392 * d - 0.813 * e
    b = c + 2.017 * d
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0)


def camera_body_yuv(forward_eval: Callable, crop: int = 224,
                    compute_dtype: Optional[torch.dtype] = None,
                    batch: Optional[int] = None, delta: bool = False):
    """The tensor program of ``make_camera_infer_fn_yuv``: ``body(model,
    yuv_u8)`` with the frame already on the model's device (as
    ``camera_body``)."""
    if delta and batch is None:
        raise ValueError("delta coding needs a batch of consecutive frames")

    def body(model, yuv):
        if delta:
            yuv = yuv420_delta_decode_device(yuv)
        x = normalize_imagenet(yuv420_to_rgb_device(yuv, crop, crop))
        return _classify(forward_eval, model, x, compute_dtype, batch is None)

    return body


def make_camera_infer_fn_yuv(forward_eval: Callable, crop: int = 224,
                             compute_dtype: Optional[torch.dtype] = None,
                             batch: Optional[int] = None, delta: bool = False):
    """Like ``make_camera_infer_fn(host_downscale=True)`` with the frame
    as planar I420 (``crop`` * 3/2, ``crop``). ``delta`` (batched only):
    the batch arrives temporally delta-coded (``yuv420_delta_encode``) and
    is reconstructed on the device, bit-exact, so the probabilities are
    the plain yuv420 path's."""
    body = camera_body_yuv(forward_eval, crop, compute_dtype, batch, delta)

    @torch.inference_mode()
    def infer(model, yuv_u8):
        return body(model, _to_device(yuv_u8, device_of(model)))

    return infer


def yuv420_delta_encode(yuv_batch: np.ndarray) -> np.ndarray:
    """Temporal delta coding of consecutive frames (axis 0 = time):
    d[0] = y[0], d[i] = y[i] - y[i-1] with uint8 wraparound, exactly
    invertible."""
    if yuv_batch.dtype != np.uint8:
        raise ValueError("delta coding expects uint8 frames")
    d = yuv_batch.copy()
    d[1:] -= yuv_batch[:-1]
    return d


def yuv420_delta_decode_device(delta_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``yuv420_delta_encode``: a cumulative sum mod 256 along
    the time axis, in int32 (batch * 255 << 2**31)."""
    total = torch.cumsum(delta_u8.to(torch.int32), dim=0)
    return (total % 256).to(torch.uint8)


def make_camera_infer_fn_yuv_delta1(forward_eval: Callable, crop: int = 224,
                                    compute_dtype: Optional[torch.dtype] = None):
    """Stateful batch-1 delta transport: the host ships ``cur - prev``
    (uint8 wraparound) and the device carries the previous frame.

    Returns ``infer(model, prev_u8, delta_u8) -> (probs, cur_u8)``;
    the caller threads ``cur_u8`` (a device tensor that never leaves the
    card) into the next call."""

    @torch.inference_mode()
    def infer(model, prev_u8, delta_u8):
        dev = device_of(model)
        cur = _to_device(prev_u8, dev) + _to_device(delta_u8, dev)  # uint8 wraps: exact
        x = normalize_imagenet(yuv420_to_rgb_device(cur, crop, crop))
        return _classify(forward_eval, model, x, compute_dtype, True), cur

    return infer


def downscale_frame(rgb: np.ndarray, crop: int = 224, shorter: int = 256) -> np.ndarray:
    """Shorter side -> ``shorter`` (cv2 INTER_AREA), center crop ``crop``.
    A frame already at the target size is only cropped: cv2 returns it
    unchanged there, so the path needs no OpenCV."""
    h, w = rgb.shape[:2]
    th, tw = resize_target(h, w, shorter)
    if (th, tw) == (h, w):
        resized = rgb
    else:
        import cv2

        resized = cv2.resize(rgb, (tw, th), interpolation=cv2.INTER_AREA)
    top, left = center_crop_offsets(th, tw, crop)
    return resized[top : top + crop, left : left + crop]


class KalmanSmoother:
    """Scalar-per-class constant-state Kalman filter over the probability
    vector: x_k = x_{k-1} + w, z_k = x_k + v."""

    def __init__(self, n: int, process_var: float = 1e-3, obs_var: float = 1e-2):
        self.x = np.full(n, 1.0 / n)
        self.p = np.ones(n)
        self.q = process_var
        self.r = obs_var

    def update(self, z: np.ndarray) -> np.ndarray:
        p_pred = self.p + self.q
        k = p_pred / (p_pred + self.r)
        self.x = self.x + k * (np.asarray(z) - self.x)
        self.p = (1.0 - k) * p_pred
        s = self.x.sum()
        return self.x / s if s > 0 else self.x


def list_available_cameras(max_cameras: int = 5) -> List[int]:
    import cv2

    available = []
    for index in range(max_cameras):
        cap = cv2.VideoCapture(index)
        if cap.read()[0]:
            available.append(index)
            cap.release()
    return available


def _open_display(log_fn):
    """Fullscreen window with click-to-toggle; returns the screen size."""
    import cv2

    screen_w, screen_h = 1920, 1080
    try:
        from screeninfo import get_monitors

        screen = get_monitors()[0]
        screen_w, screen_h = screen.width, screen.height
    except Exception:
        pass
    log_fn(f"Selected resolution: {screen_w}x{screen_h}")
    cv2.namedWindow("Camera", cv2.WND_PROP_FULLSCREEN)
    cv2.setWindowProperty("Camera", cv2.WND_PROP_FULLSCREEN, cv2.WINDOW_FULLSCREEN)
    state = {"fullscreen": True}

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN:
            state["fullscreen"] = not state["fullscreen"]
            cv2.setWindowProperty(
                "Camera", cv2.WND_PROP_FULLSCREEN,
                cv2.WINDOW_FULLSCREEN if state["fullscreen"] else cv2.WINDOW_NORMAL,
            )

    cv2.setMouseCallback("Camera", on_mouse)
    return screen_w, screen_h


def _letterbox(frame: np.ndarray, text: str, screen_w: int, screen_h: int) -> np.ndarray:
    """The frame scaled into a (screen_h, screen_w) canvas, label drawn."""
    import cv2

    fh, fw = frame.shape[:2]
    frame_ar, screen_ar = fw / fh, screen_w / screen_h
    if screen_ar > frame_ar:
        nh, nw = screen_h, int(frame_ar * screen_h)
    else:
        nw, nh = screen_w, int(screen_w / frame_ar)
    resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_LINEAR)
    canvas = np.zeros((screen_h, screen_w, 3), dtype=np.uint8)
    xo, yo = (screen_w - nw) // 2, (screen_h - nh) // 2
    canvas[yo : yo + nh, xo : xo + nw] = resized
    cv2.putText(canvas, text, (xo + 10, yo + 150), cv2.FONT_HERSHEY_SIMPLEX, 3.0,
                (0, 255, 0), 13)
    return canvas


def run_camera(
    forward_eval: Callable,
    model,
    class_names: List[str],
    *,
    save_video: bool = False,
    save_dir: str = "results",
    prob_threshold: float = 0.5,
    measure_time: bool = False,
    kalman_filter: bool = False,
    camera_index=0,
    max_frames: Optional[int] = None,
    display: Optional[bool] = None,
    host_downscale: bool = True,
    pipeline_depth: int = 1,
    transport: str = "rgb",
    log_fn=print,
) -> dict:
    """``camera_index``: a device number or a video file's path. Headless
    when there is no ``DISPLAY``. Returns the summary (frames,
    mean_latency_s, p50_ms, fps, last_label, last_prob); writes
    times_camera.json with ``measure_time``, one span a frame from its grab
    to its probabilities on the host.

    ``pipeline_depth`` > 1 keeps that many frames in flight (headless, no
    recording: an overlay needs its own frame's prediction).
    ``transport="yuv420"`` ships planar I420, ``"yuv420_delta"`` its delta
    against the previous frame, which the device carries; both need
    ``host_downscale``."""
    import cv2

    if transport not in ("rgb", "yuv420", "yuv420_delta"):
        raise ValueError("transport must be 'rgb', 'yuv420' or 'yuv420_delta'")
    if transport.startswith("yuv420") and not host_downscale:
        raise ValueError(f"transport='{transport}' requires host_downscale")

    cap = cv2.VideoCapture(camera_index)
    if not cap.isOpened():
        log_fn("Error: cannot open camera")
        return {"frames": 0}

    if display is None:
        display = bool(os.environ.get("DISPLAY"))
    screen_w, screen_h = _open_display(log_fn) if display else (1920, 1080)

    out = None
    if save_video:
        os.makedirs(save_dir, exist_ok=True)
        out = cv2.VideoWriter(os.path.join(save_dir, "camera_output.avi"),
                              cv2.VideoWriter_fourcc(*"XVID"), 20.0, (screen_w, screen_h))

    infer = None
    smoother = KalmanSmoother(len(class_names)) if kalman_filter else None
    times: List[float] = []
    frames = 0
    last_label, last_prob = "?", 0.0
    pipelined = pipeline_depth > 1 and not display and not save_video
    in_flight: List = []  # (grab time, probabilities on the device)
    delta_mode = transport == "yuv420_delta"
    prev_host: Optional[np.ndarray] = None  # last shipped frame, host copy
    prev_dev = None  # last frame on the device (never shipped again)
    device = device_of(model)

    def finish(probs, started):
        nonlocal last_label, last_prob
        probs = probs.cpu().numpy()
        if smoother is not None:
            probs = smoother.update(probs)
        pred = int(np.argmax(probs))
        prob = float(probs[pred])
        label = "Unknown" if prob < prob_threshold else class_names[pred]
        times.append(time.perf_counter() - started)
        last_label, last_prob = label, prob
        return label, prob

    while True:
        ret, frame = cap.read()
        if not ret:
            if frames == 0:
                log_fn("Error: cannot read frame from camera")
            break

        start = time.perf_counter()
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if host_downscale:
            rgb = downscale_frame(rgb)
        ship = rgb_to_yuv420(rgb) if transport.startswith("yuv420") else rgb
        if infer is None:  # first frame: warm up (cuDNN plans, resize matrices)
            if delta_mode:
                infer = make_camera_infer_fn_yuv_delta1(forward_eval, rgb.shape[0])
                prev_host = np.zeros_like(ship)
                prev_dev = torch.zeros(ship.shape, dtype=torch.uint8, device=device)
                infer(model, prev_dev, prev_dev)[0].cpu()
            elif transport == "yuv420":
                infer = make_camera_infer_fn_yuv(forward_eval, rgb.shape[0])
                infer(model, ship).cpu()
            else:
                infer = make_camera_infer_fn(forward_eval, host_downscale=host_downscale)
                infer(model, ship).cpu()
            start = time.perf_counter()

        if delta_mode:
            payload = ship - prev_host  # uint8 wraparound
            prev_host = ship
            probs, prev_dev = infer(model, prev_dev, payload)
        else:
            probs = infer(model, ship)

        if pipelined:
            in_flight.append((start, probs))
            frames += 1
            if len(in_flight) >= pipeline_depth:
                s, p = in_flight.pop(0)
                finish(p, s)
            if max_frames is not None and frames >= max_frames:
                break
            continue

        label, prob = finish(probs, start)
        frames += 1

        if display or save_video:
            canvas = _letterbox(frame, f"Label: {label}, Prob: {prob:.4f}", screen_w, screen_h)
            if display:
                cv2.imshow("Camera", canvas)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            if out is not None:
                out.write(canvas)

        if max_frames is not None and frames >= max_frames:
            break

    for s, p in in_flight:  # the pipelined tail
        finish(p, s)

    if measure_time and times:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "times_camera.json"), "w") as f:
            json.dump(times, f, indent=4)
        log_fn(f"Temps moyen de traitement par image: {np.mean(times)} secondes")
        log_fn(f"Temps total de traitement: {np.sum(times)} secondes")

    cap.release()
    if out is not None:
        out.release()
    if display:
        cv2.destroyAllWindows()
    return {
        "frames": frames,
        "mean_latency_s": float(np.mean(times)) if times else None,
        "p50_ms": float(np.percentile(times, 50) * 1e3) if times else None,
        "fps": float(1.0 / np.mean(times)) if times else None,
        "last_label": last_label,
        "last_prob": last_prob,
    }
