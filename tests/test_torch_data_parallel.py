"""Data-parallel training of the port (``--devices N``, ``--zero1``) on the
CPU: two gloo ranks spawned once for the module (``tests/torch_dp_ranks.py``
holds their bodies, which import no jax), against the port's own
one-device run of the same steps and against JAX's step on
``create_mesh(2)`` (two of the test session's virtual CPU devices).

Every case runs 2 steps on a global batch of 8 staged 40² images (crop
32) whose two halves, one a rank, have very different statistics: dark
rows on rank 0, bright ones on rank 1, so a batch norm that took one
rank's statistics would miss. The cases:

- families 1, 2 and 3 in f32 and in float64 (the float64 runs against
  JAX's 2-device step under ``jax.enable_x64``);
- mixup then cutmix, whose roll carries rows across the rank boundary;
- a batch whose valid rows are all on rank 0 (rank 1 holds padding);
- ``--grad_accum 2`` (family 3: ghost batch norm over each micro-batch's
  global rows);
- ``--zero1`` (with the EMA and the global clip) against plain data
  parallelism with the same flags, each rank's state bytes, and a state
  saved under 2 ranks resumed under 1 and the other way round;
- the style net (single-style step and ``train_multi_style``'s draws).

Separately: a rank that raises ends the run non-zero within 60 s, and the
family-3 CLI under ``--devices 2 --device cpu`` writes the files of
``--devices 1``, each once, and prints its lines once.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from tests import torch_dp_ranks as R

RANK_CASES = tuple(R.CASES)
# f32: the losses, the weights and the running statistics within 1e-5
# relative; a momentum trace (the gradient itself, whose stem kernel sums
# thousands of cancelling terms in another order on each rank) within 5e-5.
# The float64 cases hold all of them at 1e-10
F32_TOL, F32_TRACE_TOL, F64_TOL = 1e-5, 5e-5, 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {} if tree is None else {prefix: np.asarray(tree, np.float64)}


def _rel(a, b, floor=0.0):
    """||a - b|| relative to ||b||, or to ``floor`` an element where that
    is larger."""
    scale = max(np.linalg.norm(b), floor * np.sqrt(b.size), 1e-30)
    return float(np.linalg.norm(a - b) / scale)


def _inputs():
    """The batches, labels and JAX-layout weight trees (made by the JAX
    package's initialisers, one full ResNet-50 pruned for the three
    encoders; the port loads them through ``checkpoint.convert``)."""
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import multiscale_init
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import _prune_encoder
    from heuristique_style_transfer_code_tpu.nn import transformer_net as jt
    from heuristique_style_transfer_code_tpu.nn.resnet import (
        resnet50_init,
        truncated_feature_channels,
    )
    from heuristique_style_transfer_code_tpu.ops.attention import multihead_attention_init
    from heuristique_style_transfer_code_tpu.ops.linear import linear_init

    rng = np.random.RandomState(0)
    half = R.B // 2
    images = np.concatenate([rng.randint(0, 90, (R.STEPS, half, R.STAGE, R.STAGE, 3)),
                             rng.randint(160, 256, (R.STEPS, half, R.STAGE, R.STAGE, 3))],
                            axis=1).astype(np.uint8)
    labels = rng.randint(0, 4, (R.STEPS, R.B)).astype(np.int32)
    pad = labels.copy()
    pad[:, half:] = -1

    k = jax.random.split(jax.random.PRNGKey(0), 10)
    full = resnet50_init(k[0])

    def head(k1, k2, truncate):
        return {"encoder": _prune_encoder(full, truncate), "classifier": linear_init(k1, 16, 4),
                "attention": multihead_attention_init(k2, 16, 1)}

    cond = _np(jt.transformer_net_init(k[9], width=4, n_res=1, n_styles=2))

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                return {n: (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
                        for n, v in node.items()}
            return {n: perturb(v) for n, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return node

    return {
        "images": images, "labels": labels, "labels_pad": pad,
        "f1": _np({"moco": {"encoder": _prune_encoder(full, R.F1_TRUNCATE),
                            "fc": linear_init(k[1], truncated_feature_channels(R.F1_TRUNCATE),
                                              R.F1_DIM)},
                   "classifier": {"fc": linear_init(k[2], R.F1_DIM, 4)}}),
        "f2": _np(head(k[3], k[4], R.F2_TRUNCATE)),
        "f3": _np(multiscale_init(k[5], R.F3_PATCHES, ndf=8, num_classes=4, norm="batch")),
        "style_encoder": _np(head(k[6], k[7], R.STYLE_TRUNCATE)),
        "style_net": _np(jt.transformer_net_init(k[8], width=4, n_res=1)),
        "style_cond": perturb(cond),
        "style_image": rng.randint(0, 256, (40, 44, 3)).astype(np.uint8),
        "style_image2": rng.randint(0, 256, (40, 44, 3)).astype(np.uint8),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the one-device results, rank 0's and rank 1's results, the
    2-rank ZeRO-1 save resumed on one device, the spawn's seconds, the
    one-device results of ``SPREAD_CASES`` on 4 threads)."""
    root = tmp_path_factory.mktemp("dp")
    in_dir, out_dir = str(root / "in"), str(root / "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    inputs = _inputs()
    save_pytree_npz(inputs, os.path.join(in_dir, "inputs.npz"))
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))  # the ranks' exact inputs
    inputs.update(_in=in_dir, _out=in_dir)
    # the one-device 1-rank ZeRO-1 save the ranks resume from comes first
    one = {"zero1": R.CASES["zero1"](None, inputs)}
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(2, None, [], target=R.rank_main,
                             target_args=(in_dir, out_dir, RANK_CASES),
                             rendezvous_dir=str(root), deadline_s=150.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()  # the ranks run while this process takes the one-device runs
    try:
        one.update({case: fn(None, inputs) for case, fn in R.CASES.items() if case not in one})
    finally:
        job.join()
    assert "error" not in spawn, spawn
    seconds = spawn["seconds"]
    ranks = [load_pytree_npz(os.path.join(out_dir, f"rank{r}.npz")) for r in range(2)]
    resumed = R.run_classifier(None, inputs, "f2", zero1=True, ema=0.9, clip=0.5,
                               start=os.path.join(out_dir, "saved.npz"))
    return inputs, one, ranks, resumed, seconds


def _close(got, want, tol, what, floor=R.LR):
    """Every leaf within ``tol`` relative (L2), the scale being at least
    ``floor`` (the learning rate: one unit step) an element: a leaf whose
    gradient is a cancelling sum, a batch norm's bias, ends far smaller
    than the other weights, and its f32 reduction-order error, though tiny
    next to one step, is large next to the leaf itself."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), what
    for key in want:
        err = _rel(got[key], want[key], floor)
        assert err <= tol, (what, key, err, tol)


# the style net's biases ahead of an instance norm: their true gradient is
# zero, so Adam's update is its rounding noise normalised, of size lr either
# way (as tests/test_torch_fast_style_train.py explains)
def _zero_gradient_leaf(key: str) -> bool:
    parts = key.strip("/").split("/")
    return parts[-1] == "bias" and (parts[0] == "in_b" or not (
        parts[0].startswith("in") or parts[0] == "out"))


@pytest.mark.parametrize("case", RANK_CASES)
def test_two_ranks_match_one_device(runs, case):
    """Both ranks end with the same weights, bit for bit, and the global
    losses, the weights, the running statistics and the optimiser state of
    the one-device run, each leaf's L2 relative: ``F32_TOL`` and, for
    the optimiser state, ``F32_TRACE_TOL`` in f32; ``F64_TOL`` in
    float64."""
    _, one, ranks, _, _ = runs
    r0, r1 = ranks[0][case], ranks[1][case]
    for key, v in _flat(r0["params"]).items():
        np.testing.assert_array_equal(v, _flat(r1["params"])[key], err_msg=key)
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    f64 = case.endswith("_f64")
    tol = F64_TOL if f64 else F32_TOL
    np.testing.assert_allclose(r0["loss"], one[case]["loss"], rtol=tol)
    if case.startswith("style"):
        _style_close(r0["params"], one[case]["params"], 0.05)
        return
    _close(r0["params"], one[case]["params"], tol, case)
    if "opt" in one[case]:
        _close(r0["opt"], one[case]["opt"], tol if f64 else F32_TRACE_TOL, case + " opt",
               floor=_rms(one[case]["opt"]))


def _rms(tree) -> float:
    """The RMS element of a tree: the gradient scale of a trace, the floor
    of a leaf whose gradient is rounding noise (a conv bias ahead of a batch
    norm)."""
    leaves = list(_flat(tree).values())
    return float(np.sqrt(sum(np.sum(np.square(v)) for v in leaves)
                         / sum(v.size for v in leaves)))


def _style_close(got, want, share, init=None):
    """The style net's leaves after Adam's steps: each leaf's RMS gap within
    ``share`` of the steps' reach (Adam moves an element by about the
    learning rate a step whatever its gradient's size, so a gradient that
    is rounding noise, or nearly so, moves by a full step either way: the
    tolerance is a share of a step, not of the leaf); the biases ahead of
    an instance norm, whose true gradient is zero, within the reach of
    ``init`` (each side) or of each other."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    move = R.STEPS * R.STYLE_LR
    for key in want:
        if _zero_gradient_leaf(key):
            for side in (got[key], want[key]):
                ref = _flat(init)[key] if init is not None else want[key]
                assert np.abs(side - ref).max() <= 2 * move * (1 + 1e-4), key
        else:
            gap = np.sqrt(np.mean(np.square(got[key] - want[key])))
            assert gap <= share * move, (key, gap / move)


def test_batch_norm_statistics_are_global(runs):
    """The halves' statistics differ: the running statistics after the
    first step are those of the global batch, not of either rank's rows
    (the one-device run on rank 0's rows alone ends far from them)."""
    inputs, one, ranks, _, _ = runs
    local = {k: v[:, : R.B // 2] for k, v in inputs.items() if k in ("images", "labels")}
    alone = R.run_classifier(None, {**inputs, **local}, "f3", steps=1)
    got = _flat(ranks[0]["f3"]["params"])
    lone = _flat(alone["params"])
    means = [k for k in got if k.endswith("/mean")]
    assert means
    worst = max(_rel(lone[k], got[k]) for k in means)
    assert worst > 0.1, worst


def test_zero1_matches_plain_data_parallel_and_shards_the_state(runs):
    """ZeRO-1 gives plain data parallelism's numbers (same flags: EMA 0.9,
    clip 0.5) within 1e-6, and each rank keeps at most half the split
    leaves' bytes plus the replicated ones."""
    _, _, ranks, _, _ = runs
    for r in range(2):
        z, p = ranks[r]["zero1"], ranks[r]["dp_ema_clip"]
        np.testing.assert_allclose(z["loss"], p["loss"], rtol=1e-6)
        _close(z["params"], p["params"], 1e-6, "zero1 params")
        _close(z["opt"], p["opt"], 1e-6, "zero1 state", floor=_rms(p["opt"]))
        split, repl, total = (int(x) for x in z["bytes"])
        assert 0 < split <= (total - repl) / 2
        assert split + repl <= total / 2 + repl
        assert repl < 0.01 * total


def test_zero1_state_resumes_across_device_counts(runs):
    """A state saved after the first step under 2 ranks (ZeRO-1, gathered
    by rank 0) continues on one device, and the one-device save continues
    under 2 ranks: each run's second step matches the uninterrupted one
    within 1e-5."""
    _, one, ranks, resumed, _ = runs
    want = one["zero1"]
    np.testing.assert_allclose(resumed["loss"], want["loss"][1:], rtol=1e-5)
    _close(resumed["params"], want["params"], 1e-5, "2 -> 1")
    _close(resumed["opt"], want["opt"], 1e-5, "2 -> 1 state", floor=_rms(want["opt"]))
    got = ranks[0]["zero1_from_1"]
    np.testing.assert_allclose(got["loss"], want["loss"][1:], rtol=1e-5)
    _close(got["params"], want["params"], 1e-5, "1 -> 2")
    _close(got["opt"], want["opt"], 1e-5, "1 -> 2 state", floor=_rms(want["opt"]))


def _jax_classifier(family, inputs):
    """JAX's step on ``create_mesh(2)`` in float64: the global losses and
    the variables after ``STEPS`` steps."""
    from heuristique_style_transfer_code_tpu.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu.models.gram_attention import gram_attention_apply
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import multiscale_apply
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import combined_apply
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu.train.train_loop import make_train_step

    if family == "f1":
        def forward(v, x):
            logits, new_moco = combined_apply(v["moco"], v["classifier"], x, R.F1_TRUNCATE,
                                              train=True)
            return logits, {"moco": new_moco, "classifier": v["classifier"]}
    elif family == "f2":
        def forward(v, x):
            _, logits, new_v = gram_attention_apply(v, x, R.F2_TRUNCATE, R.F2_S, 4, train=True)
            return logits, new_v
    else:
        def forward(v, x):
            return multiscale_apply(v, x, "batch", train=True)
    with jax.enable_x64():
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                           inputs[family])
        optimizer = sgd_momentum(R.LR, variables)
        aug = make_augment_fn([(None, None)], crop=R.CROP)
        step = make_train_step(forward, optimizer,
                               lambda im, c, k: aug(im, c, k).astype(jnp.float64),
                               mesh=create_mesh(2))
        state = optimizer.init(variables)
        losses = []
        for i in range(R.STEPS):
            variables, state, loss = step(variables, state, jnp.asarray(inputs["images"][i]),
                                          jnp.asarray(inputs["labels"][i]),
                                          jnp.zeros(R.B, jnp.int32), jax.random.PRNGKey(i))
            losses.append(float(loss))
        return np.asarray(losses), _np(variables)


@pytest.mark.parametrize("family", R.FAMILIES)
def test_two_ranks_match_jax_two_device_step(runs, family):
    """Families 1, 2 and 3: the port's two gloo ranks and JAX's step on a
    2-device mesh, both in float64 from the same weights and batches: the
    global losses and every parameter and running statistic within 1e-6
    (the packages' f32 preprocessing feeds both)."""
    inputs, _, ranks, _, _ = runs
    losses, variables = _jax_classifier(family, inputs)
    got = ranks[0][f"{family}_f64"]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-6)
    _close(got["params"], variables, 1e-6, family)


def test_style_net_two_ranks_match_jax_two_device_step(runs):
    """The style net: the port's two ranks against JAX's
    ``make_fast_style_train_step(mesh=create_mesh(2))``, as the one-device
    test holds the packages (the first loss within 1e-5, the second 1e-3,
    each leaf within a quarter of the steps' reach, the zero-gradient
    biases within the reach of their start)."""
    from heuristique_style_transfer_code_tpu.core.mesh import create_mesh
    from heuristique_style_transfer_code_tpu.tasks import fast_style as jf
    from heuristique_style_transfer_code_tpu.tasks import style_transfer as jst

    inputs, _, ranks, _, _ = runs
    jx = jst.make_extract_fn_gram_attention(inputs["style_encoder"], R.STYLE_TRUNCATE,
                                            style_layers="all")
    init, step = jf.make_fast_style_train_step(jx, learning_rate=R.STYLE_LR, crop=R.CROP,
                                               mesh=create_mesh(2))
    grams = [jf.encode_style_grams(jx, inputs["style_image"], R.CROP)]
    params = jax.tree_util.tree_map(jnp.asarray, inputs["style_net"])
    state = init(params)
    losses = []
    for i in range(R.STEPS):
        params, state, loss = step(params, state, jnp.asarray(inputs["images"][i]), grams[0])
        losses.append(float(loss))
    got = ranks[0]["style"]
    assert abs(got["loss"][0] - losses[0]) <= 1e-5 * abs(losses[0])
    assert abs(got["loss"][1] - losses[1]) <= 1e-3 * abs(losses[1])
    _style_close(got["params"], _np(params), 0.25, init=inputs["style_net"])


def test_failing_rank_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launcher ends
    rank 0 and exits non-zero, well within 60 s."""
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        multihost.launch(2, None, [], target=R.failing_rank,
                         rendezvous_dir=str(tmp_path), deadline_s=60.0)
    assert exc.value.code not in (0, None)
    assert time.perf_counter() - t0 < 60.0


@pytest.fixture(scope="module")
def f3_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp_cfg") / "f3.json"
    path.write_text(json.dumps({"batch_size": 4, "lr": 0.01, "ndf": 8, "patch_sizes": {
        "small": 10, "medium": 20, "large": 40}, "norm": "batch", "seed": 0}))
    return str(path)


def test_cli_devices_2_writes_the_one_device_files_once(tiny_imagefolder, f3_cfg, tmp_path,
                                                        capfd):
    """``train_multi_patchgan --devices 2 --device cpu`` (two gloo
    processes) against ``--devices 1``: the same file names, every JSON
    value and saved leaf within 1e-5 relative (a leaf's L2), one line in
    ``events.jsonl`` a fold and the average, and each per-epoch line
    printed once."""
    from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import main

    printed = {}
    for n in (1, 2):
        out = tmp_path / f"d{n}"
        main(["--data", str(tiny_imagefolder), "--config_path", f3_cfg, "--epochs", "1",
              "--save_dir", str(out), "--device", "cpu", "--devices", str(n)])
        printed[n] = capfd.readouterr().out
    assert "Data-parallel training: 2 ranks (gloo)" in printed[2]
    one, two = tmp_path / "d1", tmp_path / "d2"
    assert sorted(os.listdir(one)) == sorted(os.listdir(two))
    with open(two / "events.jsonl") as f:
        assert len(f.readlines()) == 3  # two folds and the average
    for n in (1, 2):
        epochs = [line for line in printed[n].splitlines()
                  if line.startswith("Fold") and "Epoch [1/1], Loss" in line]
        assert len(epochs) == 2, printed[n]
    for name in os.listdir(one):
        if name.endswith(".npz"):
            _close(load_pytree_npz(str(two / name)), load_pytree_npz(str(one / name)), 1e-5,
                   name, floor=0.01)  # the config's lr
        elif name.endswith(".json"):
            a = json.loads((one / name).read_text().replace(str(one), "D"))
            b = json.loads((two / name).read_text().replace(str(two), "D"))
            _json_close(a, b, name)


def _json_close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _json_close(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _json_close(x, y, what)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-5, abs=1e-7), what
    else:
        assert a == b, what


def test_spawn_budget(runs):
    """The module's one spawn of two ranks, every case run on each, stays
    within the 45 s that this file has in all."""
    assert runs[4] < 45.0
