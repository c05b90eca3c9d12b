"""The servers' ``--devices N`` on the CPU, in one process: one replica a
device (``core.mesh.DeviceGroup(["cpu", "cpu"])``), the CPU counterpart of
the JAX tests' virtual devices.

- ``BatchingInferenceServer(mesh=)``: family 1 (truncate 5) through two
  replicas, each a block of 2 rows of the batch of 4, the second running
  a copy of the model of its own, answers every frame as one replica
  does (rgb, yuv420 and int8; within 1e-6, the argmax equal: f32 rows
  computed in batches of another size);
- a 2-device artifact (``export_infer_artifact(mesh=)``, the per-device
  program at 2 rows, ``n_devices`` 2 and ``batch_size`` 4 in its meta)
  served through the batcher on two replicas answers as the one-device
  live batcher, and refuses a direct call; a load with another device
  count is refused; the
  re-targeting check finds a program's devices;
- ``serve --export_artifact`` under ``--devices``: a symbolic batch, a
  batch the count does not divide and a count clamped to the visible
  cards raise the JAX CLI's ValueErrors (the numbers aside in the last:
  JAX's CPU session sees 8 devices, this host no card);
- the style service's replicas: the blocks of a batch step together until
  no job of the whole batch is active (``drive_masked_adam_blocks``
  against ``drive_masked_adam`` on the whole batch, a block stopping at
  the first iteration), and a texture-mode service and its 2-device
  artifact (its jobs a replica, ``replica_job_fns``, split by the
  service) answer each job as one device does (pixels, loss,
  iterations)."""
import os
import re

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.cli import serve as tcli
from heuristique_style_transfer_code_tpu_torch.core.mesh import DeviceGroup
from heuristique_style_transfer_code_tpu_torch.deploy import artifact as tart
from heuristique_style_transfer_code_tpu_torch.tasks.serving import BatchingInferenceServer

GROUP = DeviceGroup(["cpu", "cpu"])
BATCH, CROP = 4, 64
TIMEOUT = 120


@pytest.fixture(scope="module")
def f1_checkpoint(tmp_path_factory):
    """A family-1 checkpoint of the port's seeded weights (truncate 5, dim
    16, 4 classes; the JAX layout both CLIs read) and its config."""
    import json

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    d = tmp_path_factory.mktemp("serve_devices")
    ckpt, cfg = str(d / "f1.npz"), str(d / "f1.json")
    save_pytree_npz(to_jax_tree(truncated_resnet50_init(torch.Generator().manual_seed(2), 5, 4,
                                                        16, device="cpu")), ckpt)
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "seed": 0, "dim": 16}, f)
    return cfg, ckpt


def _argv(f1_checkpoint, *extra):
    cfg, ckpt = f1_checkpoint
    return ["--family", "truncated_resnet50", "--config_path", cfg, "--model_path", ckpt,
            "--batch_size", str(BATCH), *extra]


def _frames(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (CROP, CROP, 3)).astype(np.uint8) for _ in range(n)]


def _served(server, frames):
    with server:
        return np.stack([f.result(timeout=TIMEOUT) for f in [server.submit(x) for x in frames]])


@pytest.mark.parametrize("precision,transport", [("float32", "rgb"), ("float32", "yuv420"),
                                                 ("int8", "rgb")])
def test_batcher_replicas_answer_as_one_device(f1_checkpoint, tiny_imagefolder, tmp_path,
                                               precision, transport):
    extra = ["--precision", precision, "--device", "cpu"]
    if precision == "int8":
        extra += ["--calib_data", str(tiny_imagefolder), "--quantized_path",
                  str(tmp_path / "q.npz")]
    fwd, model, _, _ = tcli._resolve_forward(tcli.build_parser().parse_args(
        _argv(f1_checkpoint, *extra)))
    frames = _frames(7, seed=1)  # a full batch and a padded one
    kw = dict(batch_size=BATCH, max_delay_ms=20, transport=transport)
    two = BatchingInferenceServer(fwd, model, mesh=GROUP, **kw)
    assert [str(d) for d in two.devices] == ["cpu", "cpu"]
    # the second replica runs a copy of its own, as on a second card
    (_, m0, _), (_, m1, _) = two._replicas
    assert m0 is model and m1 is not model
    assert all(a is not b for a, b in zip(m0.parameters(), m1.parameters()))
    got = _served(two, frames)
    want = _served(BatchingInferenceServer(fwd, model, **kw), frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_two_device_artifact_through_the_batcher(f1_checkpoint, tmp_path, transport):
    fwd, model, _, names = tcli._resolve_forward(tcli.build_parser().parse_args(
        _argv(f1_checkpoint, "--device", "cpu")))
    blobs, meta = tart.export_infer_artifact(fwd, model, transport=transport,
                                             batch_size=BATCH, mesh=GROUP, class_names=names)
    assert (meta["n_devices"], meta["batch_size"], meta["input_shape"][0]) == (2, BATCH, BATCH)
    path = str(tmp_path / "two.npz")
    tart.save_infer_artifact(path, blobs, meta)
    art = tart.load_infer_artifact(path, devices=GROUP.devices)
    assert [str(d) for d in art.devices] == ["cpu", "cpu"]
    frames = _frames(6, seed=2)
    got = _served(BatchingInferenceServer(None, None, batch_size=BATCH, max_delay_ms=20,
                                          transport=transport, mesh=GROUP,
                                          infer_fn=art.server_infer_fns(), device="cpu"),
                  frames)
    want = _served(BatchingInferenceServer(fwd, model, batch_size=BATCH, max_delay_ms=20,
                                           transport=transport), frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    with pytest.raises(ValueError, match="server_infer_fns"):
        art(np.zeros((BATCH, CROP, CROP, 3), np.uint8))
    for devices in (None, ["cpu"] * 3):
        with pytest.raises(ValueError, match="2 device"):
            tart.load_infer_artifact(path, device="cpu", devices=devices)


def test_retargeting_check_finds_the_program_devices(f1_checkpoint):
    """A program exported on the CPU refers to the CPU alone: re-targeting
    it there is a no-op, and for another device the check names the CPU
    (a card's program loaded for another card is moved, then checked the
    same way; this host has no card to show it)."""
    fwd, model, _, _ = tcli._resolve_forward(tcli.build_parser().parse_args(
        _argv(f1_checkpoint, "--device", "cpu")))
    blobs, _ = tart.export_infer_artifact(fwd, model, batch_size=2)
    ep = tart._deserialize(blobs["cpu"])
    assert {d.type for d in tart._devices_in(ep)} == {"cpu"}
    assert tart._retarget(ep, torch.device("cpu")) is ep
    assert tart._stray_devices(ep, torch.device("cuda", 1)) == ["cpu"]


def _shape(msg: str) -> str:
    return re.sub(r"\d+", "N", msg)


@pytest.mark.parametrize("case", ["symbolic", "not_dividing", "clamped"])
def test_export_devices_errors_match_jax(f1_checkpoint, tmp_path, case):
    from heuristique_style_transfer_code_tpu.cli import serve as jcli

    path = str(tmp_path / "a.npz")
    flags = {"symbolic": ["--devices", "2"],
             "not_dividing": ["--devices", "2", "--export_batch", "3"],
             "clamped": ["--devices", "16", "--export_batch", "16"]}[case]
    with pytest.raises(ValueError) as want:
        jcli.export_artifact(jcli.build_parser().parse_args(
            _argv(f1_checkpoint, "--export_artifact", path, *flags)))
    if case == "clamped":
        # this host has no card: --device cuda sees none, so the count is clamped
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        flags = ["--devices", "2", "--export_batch", "4"]
    else:
        flags = flags + ["--device", "cpu"]
    with pytest.raises(ValueError) as got:
        tcli.main(_argv(f1_checkpoint, "--export_artifact", path, *flags))
    if case == "clamped":
        assert _shape(str(got.value)) == _shape(str(want.value))
        assert "only a 1-device mesh could be built here (0 visible)" in str(got.value)
    else:
        assert str(got.value) == str(want.value)
    assert not os.path.exists(path)


def _texture_loop(threshold, iters=4):
    """A batch of 4 texture jobs' loop on its rows: rows 0-1 start near
    their targets, rows 2-3 far."""
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    model = gram_attention_init(torch.Generator().manual_seed(0), 4, 4, 4, device="cpu")
    gram_fn = pst.make_gram_fn_gram_attention(model, 4)
    rng = np.random.RandomState(4)
    noise = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    other = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        near = gram_fn(noise + 0.01 * other)[0]
        far = gram_fn(other)[0]
    target = torch.cat([near[:2], far[2:]])
    loss = pst.make_per_image_gram_loss(gram_fn)

    def step(rows):
        return lambda *state: pst.masked_adam_step(loss, 0.01, threshold, *state[:4],
                                                   *state[4:], target[rows])

    return noise, step, iters


def test_blocks_stop_on_the_whole_batch():
    """Two blocks (a replica each) against the whole batch on one device:
    block 0's jobs stop at the first iteration, block 1's run to the cap,
    and each block reports the whole batch's iteration count and its jobs'
    losses at their frozen pixels, bit for bit."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    noise, step, iters = _texture_loop(0.0, iters=1)
    first = pst.drive_masked_adam(step(slice(0, 4)), noise, 1)[2]
    threshold = float(torch.sqrt(first[:2].max() * first[2:].min()))
    assert first[:2].max() < threshold < first[2:].min()
    noise, step, iters = _texture_loop(threshold)
    want_pixels, want_iters, want_per = pst.drive_masked_adam(step(slice(0, 4)), noise, iters)
    pixels, got_iters, per = pst.drive_masked_adam_blocks(
        [step(slice(0, 2)), step(slice(2, 4))], [noise[:2], noise[2:]], iters)
    assert got_iters == want_iters == iters
    np.testing.assert_array_equal(torch.cat(per).numpy(), want_per.numpy())
    np.testing.assert_array_equal(torch.cat(pixels).numpy(), want_pixels.numpy())
    assert not torch.equal(want_per[:2], first[:2])  # re-read at their frozen pixels


def _style_jobs(service, imgs):
    service.start()
    try:
        return [f.result(timeout=TIMEOUT) for f in [service.submit(im) for im in imgs]]
    finally:
        service.stop()


def test_style_service_and_artifact_replicas_answer_as_one_device(tmp_path):
    """Texture mode (family 2, truncate 4, crop 32, 3 iterations, a
    threshold between the jobs' first losses) on two replicas, and its
    2-device style artifact: every job's pixels, loss and iteration count
    are one device's."""
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_service import (
        StyleTransferService,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
    )

    model = gram_attention_init(torch.Generator().manual_seed(0), 4, 4, 4, device="cpu")
    gram_fn = make_gram_fn_gram_attention(model, 4)
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (32, 32, 3)).astype(np.uint8) for _ in range(4)]

    def service(threshold, iters=3, **kw):
        return StyleTransferService(gram_fn, crop=32, batch_size=4, num_iterations=iters,
                                    threshold=threshold, max_delay_ms=2000, seed=3,
                                    device="cpu", **kw)

    first = sorted(r.loss for r in _style_jobs(service(0.0, iters=1), imgs))
    threshold = float(np.sqrt(first[1] * first[2]))
    one = _style_jobs(service(threshold), imgs)
    two_svc = service(threshold, mesh=GROUP)
    assert [str(d) for d in two_svc.devices] == ["cpu", "cpu"]
    blobs, meta = tart.export_style_artifact(two_svc)
    assert (meta["n_devices"], meta["batch_sizes"]) == (2, [4])
    path = str(tmp_path / "style.npz")
    tart.save_style_artifact(path, blobs, meta)
    two = _style_jobs(two_svc, imgs)
    art = tart.load_style_artifact(path, devices=GROUP.devices)
    served_svc = StyleTransferService(job_fn=art.replica_job_fns, mesh=GROUP, crop=32,
                                      max_delay_ms=2000, num_iterations=3, device="cpu")
    served = _style_jobs(served_svc, imgs)
    assert {r.iterations for r in one} == {3}
    for got in (two, served):
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a.image, b.image)
            assert (a.loss, a.iterations) == (b.loss, b.iterations)
