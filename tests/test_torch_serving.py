"""The port's ``tasks/serving.py`` and ``tasks/serving_http.py`` against the
JAX package's, on the CPU.

The same frames go through the port's ``BatchingInferenceServer`` (the
linear model of ``tests/torch_linear_serving.py``) and JAX's (the same
weights, ``tests/linear_serving.py``): full batches from threads, a
deadline flush, a padded batch, a backlog, the yuv420 transport;
probabilities within rtol = atol = 1e-4 (the f32 matmul summed in another
order). ``prepare_frame`` downscales an oversized frame bit for bit as
JAX's does and raises its errors word for word. Also the lifecycle (drain,
cancel, submit after stop), dispatch errors and ``health``'s
consecutive-failure rule, and the HTTP layer against JAX's
``make_http_server``: the /predict JSON, the /stats keys, the /metrics
names, and the 400, 404 and 503 answers."""
import http.client
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.tasks import serving as jserving
from heuristique_style_transfer_code_tpu.tasks import serving_http as jhttp
from heuristique_style_transfer_code_tpu_torch.tasks import serving as tserving
from heuristique_style_transfer_code_tpu_torch.tasks import serving_http as thttp
from tests.linear_serving import linear_forward as j_forward
from tests.linear_serving import linear_variables, rgb_frames
from tests.torch_linear_serving import CLASSES, CROP, Linear, linear_forward

PROBS = dict(rtol=1e-4, atol=1e-4)
NAMES = ["fog", "rain", "snow", "sun"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return Linear()


def _port(model, **kw):
    kw.setdefault("crop", CROP)
    return tserving.BatchingInferenceServer(linear_forward, model, **kw)


def _jax(**kw):
    kw.setdefault("crop", CROP)
    return jserving.BatchingInferenceServer(j_forward, linear_variables(), **kw)


def _serve_all(server, frames, threads=1):
    futs = [None] * len(frames)
    per = len(frames) // threads

    def client(lo, hi):
        for i in range(lo, hi):
            futs[i] = server.submit(frames[i])

    with server:
        workers = [threading.Thread(target=client, args=(k * per, (k + 1) * per))
                   for k in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        results = [f.result(timeout=60) for f in futs]
    return results, server.stats()


def test_full_batches_from_many_threads_match_jax(model):
    frames = rgb_frames(32, seed=1)
    got, stats = _serve_all(_port(model, batch_size=8, max_delay_ms=50), frames, threads=4)
    want, j_stats = _serve_all(_jax(batch_size=8, max_delay_ms=50), frames, threads=4)
    for g, w in zip(got, want):
        assert g.shape == (CLASSES,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **PROBS)
    assert set(stats) == set(j_stats)
    assert stats["images"] == 32 and stats["batches"] >= 4
    assert 0 < stats["latency_p50_ms"] <= stats["latency_p95_ms"]


def test_deadline_flush_partial_batch(model):
    frames = rgb_frames(3, seed=2)
    server = _port(model, batch_size=16, max_delay_ms=30)
    with server:
        server.submit(frames[0]).result(timeout=60)
        t0 = time.perf_counter()
        got = [f.result(timeout=30) for f in [server.submit(f) for f in frames]]
        waited = time.perf_counter() - t0
    want, _ = _serve_all(_jax(batch_size=16, max_delay_ms=30), frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PROBS)
    assert waited < 5.0  # flushed by the deadline, not waiting for 16
    stats = server.stats()
    assert stats["images"] == 4 and stats["mean_batch_occupancy"] < 1.0


def test_padding_does_not_change_results(model):
    frame = rgb_frames(1, seed=3)[0]
    with _port(model, batch_size=8, max_delay_ms=10) as server:
        solo = server.submit(frame).result(timeout=60)  # a padded batch of 1
        futs = [server.submit(f) for f in rgb_frames(7, seed=4)] + [server.submit(frame)]
        full = futs[-1].result(timeout=30)
    np.testing.assert_allclose(solo, full, rtol=1e-6, atol=1e-7)


def test_backlog_drains_as_full_batches(model):
    server = _port(model, batch_size=8, max_delay_ms=1)
    futs = [server.submit(f) for f in rgb_frames(16, seed=5)]  # queued before the start
    with server:
        [f.result(timeout=60) for f in futs]
    assert server.stats()["batches"] == 2
    assert server.stats()["mean_batch_occupancy"] == 1.0


def test_oversized_frame_downscaled_bit_for_bit_as_jax(model):
    big = np.random.RandomState(6).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    got = tserving.prepare_frame(big, CROP)
    want = jserving.prepare_frame(big, CROP)
    assert got.shape == (CROP, CROP, 3)
    np.testing.assert_array_equal(got, want)
    with _port(model, batch_size=2, max_delay_ms=5) as server:
        via_big = server.submit(big).result(timeout=60)
        via_small = server.submit(got).result(timeout=60)
    np.testing.assert_array_equal(via_big, via_small)
    j_want, _ = _serve_all(_jax(batch_size=2, max_delay_ms=5), [big])
    np.testing.assert_allclose(via_big, j_want[0], **PROBS)


def test_yuv420_transport_matches_jax(model):
    frames = rgb_frames(6, seed=7)
    got, stats = _serve_all(_port(model, batch_size=4, max_delay_ms=5, transport="yuv420"),
                            frames)
    want, _ = _serve_all(_jax(batch_size=4, max_delay_ms=5, transport="yuv420"), frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PROBS)
    assert stats["images"] == 6


@pytest.mark.parametrize("bad", [np.zeros((CROP, CROP), np.uint8),
                                 np.zeros((CROP, CROP, 4), np.uint8),
                                 np.zeros((0, CROP, 3), np.uint8),
                                 np.zeros((CROP, CROP, 3), np.float32)],
                         ids=["gray", "rgba", "empty", "float32"])
def test_malformed_frame_rejected_in_submit_as_jax(model, bad):
    with pytest.raises(ValueError) as want:
        jserving.prepare_frame(bad, CROP)
    with _port(model, batch_size=2, max_delay_ms=5) as server:
        with pytest.raises(ValueError) as got:
            server.submit(bad)
        assert str(got.value) == str(want.value)
        # the server goes on
        assert server.submit(rgb_frames(1)[0]).result(timeout=60).shape == (CLASSES,)


def test_drain_cancel_and_submit_after_stop(model):
    server = _port(model, batch_size=4, max_delay_ms=1000).start()
    futs = [server.submit(f) for f in rgb_frames(6, seed=8)]
    server.stop(drain=True)  # flushes the 2-frame tail despite the delay
    assert all(f.result(timeout=5).shape == (CLASSES,) for f in futs)
    with pytest.raises(RuntimeError, match="server is stopped"):
        server.submit(rgb_frames(1)[0])
    # a cancelled future does not kill the server
    with _port(model, batch_size=2, max_delay_ms=200) as server:
        gone = server.submit(rgb_frames(1, seed=9)[0])
        assert gone.cancel()
        assert server.submit(rgb_frames(1, seed=10)[0]).result(timeout=60).shape == (CLASSES,)
        assert server.healthy()
    # stop without drain cancels what is queued; a never-started server stops
    idle = _port(model, batch_size=2, max_delay_ms=5)
    queued = idle.submit(rgb_frames(1)[0])
    idle.stop(drain=False)
    assert queued.cancelled()
    assert idle.health() == (False, "batcher not running")


def test_dispatch_error_fails_the_batch_and_health_degrades_as_jax():
    def boom(model, batch):
        raise ValueError("device exploded")

    servers = {"port": tserving.BatchingInferenceServer(None, None, batch_size=2,
                                                        max_delay_ms=1, crop=CROP,
                                                        infer_fn=boom, device="cpu"),
               "jax": jserving.BatchingInferenceServer(None, None, batch_size=2, max_delay_ms=1,
                                                       crop=CROP, infer_fn=boom)}
    health = {}
    for side, server in servers.items():
        with server:
            seen = []
            for i in range(3):
                assert server.health() == (True, "ok")
                with pytest.raises(ValueError, match="device exploded"):
                    server.submit(rgb_frames(1, seed=i)[0]).result(timeout=60)
                seen.append(server.health())
            health[side] = seen
    assert health["port"] == health["jax"]
    assert health["port"][-1] == (False, "device path failing (3 consecutive batch errors)")


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_mesh_is_not_ported(model, transport):
    """``mesh=`` is ported: two CPU replicas (``DeviceGroup(["cpu",
    "cpu"])``, a block of 4 rows each) answer every frame as one replica
    does, bit for bit (each row's forward is the same), and JAX's server
    within ``PROBS``; a batch the group does not divide is refused."""
    from heuristique_style_transfer_code_tpu_torch.core.mesh import DeviceGroup

    frames = rgb_frames(12, seed=11)
    kw = dict(batch_size=8, max_delay_ms=20, transport=transport)
    two, stats = _serve_all(_port(model, mesh=DeviceGroup(["cpu", "cpu"]), **kw), frames)
    one, _ = _serve_all(_port(model, **kw), frames)
    want, _ = _serve_all(_jax(**kw), frames)
    for a, b, w in zip(two, one, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, w, **PROBS)
    assert stats["images"] == 12
    with pytest.raises(ValueError, match="not divisible by the 2 devices"):
        _port(model, batch_size=5, mesh=DeviceGroup(["cpu", "cpu"]))


def test_cuda_without_a_card_raises(model):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.BatchingInferenceServer(None, None, infer_fn=lambda m, b: b)


# ---- HTTP -------------------------------------------------------------


class _Http:
    def __init__(self, http_mod, batcher, **kw):
        self.srv = http_mod.make_http_server(batcher, NAMES, **kw)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        host, port = self.srv.server_address
        self.conn = http.client.HTTPConnection(host, port, timeout=60)

    def __call__(self, method, path, body=None, headers=None):
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, r.read()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _raw(frame):
    return dict(body=frame.tobytes(), headers={"X-Raw-Shape": ",".join(map(str, frame.shape))})


def _metric_names(text: str):
    return [line.split(" ")[0].split("{")[0] if not line.startswith("#") else line
            for line in text.strip().splitlines()]


def test_http_front_end_matches_jax(model):
    from PIL import Image

    rng = np.random.RandomState(13)
    frame = rng.randint(0, 256, (CROP, CROP, 3), dtype=np.uint8)
    big = rng.randint(0, 256, (48, 64, 3), dtype=np.uint8)
    png = io.BytesIO()
    Image.fromarray(big).save(png, format="PNG")
    answers = {}
    for side, http_mod, make in (("port", thttp, lambda: _port(model, batch_size=4,
                                                                max_delay_ms=5)),
                                 ("jax", jhttp, lambda: _jax(batch_size=4, max_delay_ms=5))):
        with make() as batcher:
            client = _Http(http_mod, batcher)
            try:
                out = {"healthz": client("GET", "/healthz")}
                out["raw"] = client("POST", "/predict", **_raw(frame))
                out["png"] = client("POST", "/predict", body=png.getvalue())
                out["stats"] = client("GET", "/stats")
                out["metrics"] = client("GET", "/metrics")
                out["bad_body"] = client("POST", "/predict", body=b"not an image")
                out["rgba"] = client("POST", "/predict",
                                     **_raw(np.zeros((CROP, CROP, 4), np.uint8)))
                out["short"] = client("POST", "/predict", body=b"\0" * 10,
                                      headers={"X-Raw-Shape": f"{CROP},{CROP},3"})
                out["get_404"] = client("GET", "/nope")
                out["post_404"] = client("POST", "/style", body=b"")
                out["healthz_after"] = client("GET", "/healthz")
            finally:
                client.close()
        answers[side] = out
    port, jax_ = answers["port"], answers["jax"]
    for key in ("healthz", "raw", "png", "stats", "metrics", "bad_body", "rgba", "short",
                "get_404", "post_404", "healthz_after"):
        assert port[key][0] == jax_[key][0], key
    assert port["healthz"] == (200, b'{"ok": true}')
    for key in ("raw", "png"):
        got, want = json.loads(port[key][1]), json.loads(jax_[key][1])
        assert set(got) == set(want) == {"probs", "class", "prob"}
        np.testing.assert_allclose(got["probs"], want["probs"], **PROBS)
        assert got["class"] == want["class"]
    assert set(json.loads(port["stats"][1])) == set(json.loads(jax_["stats"][1]))
    assert (_metric_names(port["metrics"][1].decode())
            == _metric_names(jax_["metrics"][1].decode()))
    assert "hst_images_total 2" in port["metrics"][1].decode()
    for key in ("bad_body", "rgba", "short"):
        assert port[key][0] == 400 and json.loads(port[key][1])["error"]
    assert json.loads(port["rgba"][1]) == json.loads(jax_["rgba"][1])
    assert port["get_404"] == jax_["get_404"] == (404, b'{"error": "not found"}')


def test_http_server_faults_answer_503(model):
    def boom(model, batch):
        raise ValueError("device exploded")

    def stuck(model, batch):
        time.sleep(1.0)
        return np.full((batch.shape[0], CLASSES), 0.25, np.float32)

    frame = rgb_frames(1, seed=30)[0]
    for infer, timeout_s, error in ((boom, 30.0, "device exploded"), (stuck, 0.2, "")):
        batcher = tserving.BatchingInferenceServer(None, None, batch_size=2, max_delay_ms=1,
                                                   crop=CROP, infer_fn=infer,
                                                   device="cpu").start()
        client = _Http(thttp, batcher, timeout_s=timeout_s)
        try:
            status, body = client("POST", "/predict", **_raw(frame))
            assert status == 503 and json.loads(body)["error"]
            assert error in json.loads(body)["error"]
            if infer is boom:
                for _ in range(2):
                    client("POST", "/predict", **_raw(frame))
                status, body = client("GET", "/healthz")
                assert status == 503
                assert json.loads(body) == {
                    "ok": False, "error": "device path failing (3 consecutive batch errors)"}
                assert "hst_healthy 0" in client("GET", "/metrics")[1].decode()
        finally:
            client.close()
            batcher.stop(drain=True)
    # a stopped batcher: 503
    batcher = _port(model, batch_size=2, max_delay_ms=1).start()
    client = _Http(thttp, batcher)
    try:
        batcher.stop()
        status, body = client("POST", "/predict", **_raw(frame))
        assert status == 503 and "stopped" in json.loads(body)["error"]
        assert client("GET", "/healthz")[0] == 503
    finally:
        client.close()


def test_serve_http_starts_a_thread(model):
    with _port(model, batch_size=2, max_delay_ms=1) as batcher:
        srv = thttp.serve_http(batcher, NAMES, port=0)
        try:
            host, port = srv.server_address
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request("POST", "/predict", **_raw(rgb_frames(1)[0]))
            assert conn.getresponse().status == 200
        finally:
            srv.shutdown()
            srv.server_close()


def test_http_servers_take_a_burst_of_connections(model):
    """The listen backlog holds a burst of clients (the default of 5 makes
    the connections beyond it wait a TCP retransmission), for the style
    front end too."""
    from heuristique_style_transfer_code_tpu_torch.tasks import style_http

    assert thttp.HTTPServer.request_queue_size >= 64
    with _port(model, batch_size=8, max_delay_ms=1) as batcher:
        srv = thttp.make_http_server(batcher, NAMES)
        assert isinstance(srv, thttp.HTTPServer)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        host, port = srv.server_address
        frames = rgb_frames(32, seed=40)

        def post(frame):
            conn = http.client.HTTPConnection(host, port, timeout=60)
            conn.request("POST", "/predict", **_raw(frame))
            return conn.getresponse().status

        try:
            with ThreadPoolExecutor(32) as pool:
                assert list(pool.map(post, frames)) == [200] * 32
        finally:
            srv.shutdown()
            srv.server_close()
    srv = style_http.make_style_http_server(type("S", (), {"crop": CROP})(), port=0)
    assert isinstance(srv, thttp.HTTPServer)
    srv.server_close()
