"""The port's ``tasks/recycling.py`` against the JAX package's, on the CPU.

``strip_flag`` against JAX's. The proxy over the light linear builder of
``tests/torch_linear_serving.py`` (a spawned worker imports torch and the
port, no JAX and no ResNet): one recycle with no failed request, every
answer equal to the in-process port server's bit for bit and to JAX's
``BatchingInferenceServer`` within rtol = atol = 1e-4, the same frame
answered alike by two workers; a child's validation error reaching its
Future; and the two repairs of the JAX file: a reply that does not pickle
resolves its Future with an error and frees its window slot (JAX drops
it, so the Future hangs), and a builder that does not report its queue
bound gets the small window (JAX keeps 384). Then ``serve_style
--recycle_after_requests`` through the CLI's own ``start_recycling`` with
a tiny style net on the CPU: a worker killed with two jobs in it, the
jobs replayed on its successor, every answer equal to the in-process
service's. Four workers are spawned in all. The parent never initialises
CUDA."""
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.tasks import recycling as jrecycling
from heuristique_style_transfer_code_tpu.tasks.serving import BatchingInferenceServer as JServer
from heuristique_style_transfer_code_tpu_torch.tasks import recycling as trecycling
from heuristique_style_transfer_code_tpu_torch.tasks.serving import BatchingInferenceServer
from tests.linear_serving import linear_forward as j_forward
from tests.linear_serving import linear_variables, rgb_frames
from tests.torch_linear_serving import CLASSES, CROP, UNSENDABLE, Linear, linear_forward

LINEAR_BUILDER = "tests.torch_linear_serving:recycling_builder"
PROBS = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("argv", [
    ["--a", "1", "--recycle_after_requests", "5", "--b"],
    ["--recycle_after_requests=5", "--b"],
    ["--recycle_after_requests"],
    [],
])
def test_strip_flag_matches_jax(argv):
    name = "--recycle_after_requests"
    assert trecycling.strip_flag(list(argv), name) == jrecycling.strip_flag(list(argv), name)
    assert name not in " ".join(trecycling.strip_flag(list(argv), name))


def _in_process(frames):
    server = BatchingInferenceServer(linear_forward, Linear(), batch_size=4, max_delay_ms=5,
                                     crop=CROP)
    with server:
        return [f.result(timeout=60) for f in [server.submit(x) for x in frames]]


def test_recycle_with_no_failure_same_answers_and_the_two_repairs():
    frames = rgb_frames(8, seed=3)
    proxy = trecycling.RecyclingServiceProxy(LINEAR_BUILDER, [], recycle_after=6).start()
    try:
        # repair 2: the ready info names no max_queue, so the window is small
        assert proxy._max_in_worker == trecycling.UNKNOWN_QUEUE_WINDOW < 384
        first_pid = proxy.info["worker_pid"]
        # the child's own validation comes back as the Future's error
        bad = proxy.submit(np.zeros((CROP, CROP, 3), np.float32))
        with pytest.raises(ValueError, match="frame must be uint8"):
            bad.result(timeout=120)
        # repair 1: a reply that does not pickle is an error reply
        unsendable = proxy.submit(np.full((CROP, CROP, 3), UNSENDABLE, np.uint8))
        with pytest.raises(RuntimeError, match="could not send its reply"):
            unsendable.result(timeout=120)
        futs = [proxy.submit(f) for f in frames]  # the 6th request starts the recycle
        got = [f.result(timeout=300) for f in futs]
        again = proxy.submit(frames[0]).result(timeout=300)
        stats = proxy.stats()
        assert stats["recycles"] == 1 and stats["worker_crashes"] == 0, stats
        assert stats["worker_pid"] != first_pid
        assert stats["images"] == 9 and stats["pending"] == 0 and stats["requests"] == 11
        assert proxy._in_worker == 0  # every window slot came back
        assert proxy.healthy()
        for key in ("batches", "images", "mean_batch_occupancy", "throughput_imgs_per_sec",
                    "latency_p50_ms", "latency_p95_ms"):
            assert key in stats
    finally:
        proxy.stop(drain=True)
    with pytest.raises(RuntimeError, match="stopped"):
        proxy.submit(frames[0])
    assert not torch.cuda.is_initialized()
    want = _in_process(frames)
    for g, w in zip(got, want):
        assert g.shape == (CLASSES,) and isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(again, got[0])  # a later worker, the same bits
    with JServer(j_forward, linear_variables(), batch_size=4, max_delay_ms=5, crop=CROP) as js:
        j_want = [f.result(timeout=60) for f in [js.submit(x) for x in frames]]
    for g, w in zip(got, j_want):
        np.testing.assert_allclose(g, w, **PROBS)


def test_wire_values_are_host_values():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    out = trecycling._to_wire(t)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, t.detach().numpy())
    for value in (b"x", 3, np.zeros(2)):
        assert trecycling._to_wire(value) is value


@pytest.fixture(scope="module")
def net_path(tmp_path_factory):
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_model_and_hyperparameters
    from heuristique_style_transfer_code_tpu.nn.transformer_net import transformer_net_init

    d = str(tmp_path_factory.mktemp("style_net"))
    params = jax.tree_util.tree_map(
        np.asarray, transformer_net_init(jax.random.PRNGKey(0), width=4, n_res=1))
    return save_model_and_hyperparameters(params, {"crop": CROP, "style_names": ["stripes"]},
                                          d, "style_net")


def test_serve_style_recycling_replays_a_crashed_worker(net_path):
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    flags = ["--net", net_path, "--batch_size", "4", "--max_delay_ms", "1500", "--port", "0",
             "--device", "cpu"]
    images = [np.random.RandomState(i).randint(0, 256, (40, 40, 3)).astype(np.uint8)
              for i in range(6)]
    args = serve_style.build_parser().parse_args(flags)
    service = serve_style._start_service(args)
    try:
        want = [f.result(timeout=120).image for f in [service.submit(im) for im in images]]
    finally:
        service.stop()

    argv = flags + ["--recycle_after_requests", "100"]
    srv, proxy = serve_style.start_recycling(serve_style.build_parser().parse_args(argv), argv)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert proxy.style_names == ["stripes"] and proxy.crop == CROP
        assert proxy.device == "cpu"
        # a full batch over HTTP, answered by the first worker
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/style", body=images[0].tobytes(),
                     headers={"X-Raw-Shape": "40,40,3"})
        futs = [proxy.submit(im) for im in images[1:4]]
        r = conn.getresponse()
        assert r.status == 200
        answers = [decode_png(r.read())] + [f.result(timeout=120).image for f in futs]
        # two jobs wait in the worker for the 1.5 s deadline: kill it there
        pid = proxy.info["worker_pid"]
        held = [proxy.submit(im) for im in images[4:]]
        proxy._proc.kill()
        answers += [f.result(timeout=300).image for f in held]
        stats = proxy.stats()
        assert stats["worker_crashes"] == 1 and stats["recycles"] == 0, stats
        assert stats["jobs"] == 6 and stats["pending"] == 0
        assert proxy.info["worker_pid"] != pid
        for key in ("jobs", "batches", "mean_batch_occupancy", "mean_iterations",
                    "jobs_per_sec", "batch_size_hist", "latency_p50_ms", "latency_p95_ms"):
            assert key in stats
        conn.request("GET", "/styles")
        assert json.loads(conn.getresponse().read()) == {"styles": ["stripes"]}
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        with pytest.raises(ValueError, match="texture mode takes no style|unknown style"):
            proxy.submit(images[0], style="nope")  # validated in this process
    finally:
        srv.shutdown()
        srv.server_close()
        proxy.stop(drain=True)
    assert not torch.cuda.is_initialized()
    for g, w in zip(answers, want):
        np.testing.assert_array_equal(g, w)
