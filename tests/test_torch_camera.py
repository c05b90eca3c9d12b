"""Camera mode on the port against the JAX package: the PIL-parity resize
matrices (bit-equal), ``resize_shorter_side`` and ``preprocess`` (1e-5),
the I420 decode (1e-6), the temporal delta coding (exact), every infer
function against its JAX twin on the ``f1_checkpoint`` model (1e-4; the
stateful delta1 path threaded over consecutive frames), the Kalman
smoother (1e-12), and ``run_camera`` on a 64x48 MJPG file for each
transport, whose frames, last label and times_camera.json match the JAX
run's (the last probability within 1e-4)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.checkpoint.io import load_pytree_npz as j_load
from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
    combined_apply as j_combined,
)
from heuristique_style_transfer_code_tpu.ops import resize as jresize
from heuristique_style_transfer_code_tpu.tasks import camera as jcam
from heuristique_style_transfer_code_tpu_torch.cli._common import load_truncated_resnet50
from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import combined_apply
from heuristique_style_transfer_code_tpu_torch.ops import resize as tresize
from heuristique_style_transfer_code_tpu_torch.tasks import camera as tcam

TRUNCATE = 5
CLASSES = ["fog", "rain", "snow", "sun"]
PROBS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models(f1_checkpoint):
    """(JAX variables, JAX forward, port model, port forward) of the
    fixture's checkpoint."""
    _, ckpt = f1_checkpoint
    variables = j_load(ckpt)

    def j_forward(v, images):
        return j_combined(v["moco"], v["classifier"], images, TRUNCATE)[0]

    def t_forward(m, images):
        return combined_apply(m.moco, m.classifier, images, TRUNCATE)

    return variables, j_forward, load_truncated_resnet50(ckpt, TRUNCATE, torch.device("cpu")), \
        t_forward


def _video(n=6, h=32, w=32, seed=0):
    """Correlated frames: a base frame plus a small drift a frame."""
    rng = np.random.RandomState(seed)
    cur = rng.randint(0, 256, (h, w, 3)).astype(np.int16)
    frames = []
    for _ in range(n):
        cur = np.clip(cur + rng.randint(-2, 3, cur.shape), 0, 255)
        frames.append(cur.astype(np.uint8))
    return frames


@pytest.mark.parametrize("in_size,out_size", [(48, 256), (64, 341), (480, 256), (640, 341),
                                              (7, 3), (256, 256)])
def test_resize_matrix_bit_equal(in_size, out_size):
    want = np.asarray(jresize.resize_matrix(in_size, out_size))
    got = tresize.resize_matrix(in_size, out_size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(48, 64, 3), (2, 61, 37, 3)])
def test_resize_shorter_side_and_preprocess_match_jax(shape):
    u8 = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    x = u8.astype(np.float32) / 255.0
    want = np.asarray(jresize.resize_shorter_side(jnp.asarray(x), 40))
    got = tresize.resize_shorter_side(torch.from_numpy(x), 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jresize.preprocess(jnp.asarray(u8), crop=32, shorter=40))
    got = tresize.preprocess(torch.from_numpy(u8), crop=32, shorter=40)
    assert got.shape == want.shape == shape[:-3] + (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_yuv420_to_rgb_matches_jax():
    frames = np.stack([jcam.rgb_to_yuv420(f) for f in _video(3, 16, 24)])
    np.testing.assert_array_equal(np.stack([tcam.rgb_to_yuv420(f) for f in _video(3, 16, 24)]),
                                  frames)
    want = np.asarray(jcam.yuv420_to_rgb_device(jnp.asarray(frames[0]), 16, 24))
    got = tcam.yuv420_to_rgb_device(torch.from_numpy(frames[0]), 16, 24)
    assert got.shape == (16, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    batched = tcam.yuv420_to_rgb_device(torch.from_numpy(frames), 16, 24)  # frames leading
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())


def test_delta_coding_round_trips_and_matches_jax():
    yuv = np.stack([jcam.rgb_to_yuv420(f) for f in _video()])
    enc = tcam.yuv420_delta_encode(yuv)
    np.testing.assert_array_equal(enc, jcam.yuv420_delta_encode(yuv))
    dec = tcam.yuv420_delta_decode_device(torch.from_numpy(enc))
    assert dec.dtype == torch.uint8
    np.testing.assert_array_equal(dec.numpy(), yuv)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jcam.yuv420_delta_decode_device(jnp.asarray(enc))))
    with pytest.raises(ValueError, match="uint8"):
        tcam.yuv420_delta_encode(yuv.astype(np.int16))


@pytest.mark.parametrize("host_downscale,batch", [(True, None), (True, 3), (False, None)])
def test_rgb_infer_fn_matches_jax(models, host_downscale, batch):
    variables, j_forward, model, t_forward = models
    frames = np.stack(_video(3, 32, 32) if host_downscale else _video(3, 48, 64))
    frame = frames if batch else frames[0]
    want = np.asarray(jcam.make_camera_infer_fn(j_forward, batch=batch,
                                                host_downscale=host_downscale)(
        variables, jnp.asarray(frame)))
    got = tcam.make_camera_infer_fn(t_forward, batch=batch,
                                    host_downscale=host_downscale)(model, frame)
    assert got.shape == want.shape == ((3, 4) if batch else (4,))
    np.testing.assert_allclose(got.numpy(), want, **PROBS)


@pytest.mark.parametrize("batch,delta", [(None, False), (6, False), (6, True)])
def test_yuv_infer_fn_matches_jax(models, batch, delta):
    variables, j_forward, model, t_forward = models
    yuv = np.stack([jcam.rgb_to_yuv420(f) for f in _video()])
    ship = yuv420 = yuv if batch else yuv[0]
    if delta:
        ship = jcam.yuv420_delta_encode(yuv)
    want = np.asarray(jcam.make_camera_infer_fn_yuv(j_forward, 32, batch=batch, delta=delta)(
        variables, jnp.asarray(ship)))
    got = tcam.make_camera_infer_fn_yuv(t_forward, 32, batch=batch, delta=delta)(model, ship)
    np.testing.assert_allclose(got.numpy(), want, **PROBS)
    if delta:  # the reconstruction is exact: the plain path's probabilities
        plain = tcam.make_camera_infer_fn_yuv(t_forward, 32, batch=batch)(model, yuv420)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="batch of consecutive frames"):
        tcam.make_camera_infer_fn_yuv(t_forward, 32, delta=True)


def test_stateful_delta1_matches_jax_and_plain(models):
    variables, j_forward, model, t_forward = models
    frames = [jcam.rgb_to_yuv420(f) for f in _video()]
    j_delta1 = jcam.make_camera_infer_fn_yuv_delta1(j_forward, 32)
    t_delta1 = tcam.make_camera_infer_fn_yuv_delta1(t_forward, 32)
    plain = tcam.make_camera_infer_fn_yuv(t_forward, 32)
    prev_host = np.zeros_like(frames[0])
    j_prev = jnp.zeros(frames[0].shape, dtype=jnp.uint8)
    t_prev = torch.zeros(frames[0].shape, dtype=torch.uint8)
    for f in frames:
        payload = f - prev_host  # uint8 wraparound
        prev_host = f
        j_probs, j_prev = j_delta1(variables, j_prev, jnp.asarray(payload))
        t_probs, t_prev = t_delta1(model, t_prev, payload)
        np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), **PROBS)
        np.testing.assert_allclose(t_probs.numpy(), plain(model, f).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t_prev.numpy(), frames[-1])  # the carried frame is exact


def test_kalman_smoother_matches_jax():
    rng = np.random.RandomState(3)
    j, t = jcam.KalmanSmoother(4), tcam.KalmanSmoother(4)
    for _ in range(10):
        z = rng.dirichlet(np.ones(4))
        np.testing.assert_allclose(t.update(z), j.update(z), rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("cam") / "in.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for f in _video(5, 48, 48):
        w.write(cv2.cvtColor(np.pad(f, ((0, 0), (0, 16), (0, 0)), mode="edge"),
                             cv2.COLOR_RGB2BGR))
    w.release()
    return path


@pytest.mark.parametrize("kwargs", [
    dict(transport="rgb", kalman_filter=True),
    dict(transport="rgb", host_downscale=False),
    dict(transport="yuv420", pipeline_depth=2),
    dict(transport="yuv420_delta"),
])
def test_run_camera_matches_jax(models, video_file, tmp_path, kwargs):
    variables, j_forward, model, t_forward = models
    common = dict(camera_index=video_file, max_frames=5, display=False, measure_time=True,
                  prob_threshold=0.0, log_fn=lambda msg: None)
    want = jcam.run_camera(j_forward, variables, CLASSES, save_dir=str(tmp_path / "jax"),
                           **common, **kwargs)
    got = tcam.run_camera(t_forward, model, CLASSES, save_dir=str(tmp_path / "torch"),
                          **common, **kwargs)
    assert list(got) == list(want)
    assert got["frames"] == want["frames"] == 5
    assert got["last_label"] == want["last_label"]
    np.testing.assert_allclose(got["last_prob"], want["last_prob"], **PROBS)
    lens = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "times_camera.json") as f:
            lens.append(len(json.load(f)))
    assert lens == [5, 5]


@pytest.mark.parametrize("kwargs,match", [
    (dict(transport="bogus"), "transport must be"),
    (dict(transport="yuv420", host_downscale=False), "requires host_downscale"),
])
def test_run_camera_refuses_what_jax_refuses(models, video_file, kwargs, match):
    variables, j_forward, model, t_forward = models
    with pytest.raises(ValueError, match=match) as j_err:
        jcam.run_camera(j_forward, variables, CLASSES, camera_index=video_file, **kwargs)
    with pytest.raises(ValueError, match=match) as t_err:
        tcam.run_camera(t_forward, model, CLASSES, camera_index=video_file, **kwargs)
    assert str(t_err.value) == str(j_err.value)
