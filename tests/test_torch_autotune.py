"""``--auto_batch``: the port's ``train/autotune.py`` against the JAX
package's, on the CPU.

- ``batch_candidates``, ``autotune_batch`` (a fake measure, one that
  raises, one that never fits) and ``describe_report`` give JAX's
  outputs;
- ``device_hbm_bytes`` is None on the CPU, as JAX's is there;
- the CPU estimate of a step grows with the batch, and a probe leaves the
  global generators and the setup's own init unchanged;
- the CLI exits with JAX's messages under ``--grad_accum 2``, a schedule,
  and on the CPU without ``--hbm_budget_gb``; a budget below the
  configured batch's step exits with JAX's message.

The three train CLIs' adopted batch, its saved hyperparameters and the
run's unchanged initialisation are held in their own test files
(``tests/torch_train_flags.py``). Sizes: family 2 at truncate 5, S 4."""
import json

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.train import autotune as pa

CANDIDATE_CASES = [(32, 1, 4096), (3, 1, 64), (6, 4, 100), (5, 8, 80), (1, 1, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("base,divisor,max_batch", CANDIDATE_CASES)
def test_batch_candidates_match_jax(base, divisor, max_batch):
    from heuristique_style_transfer_code_tpu.train.autotune import batch_candidates

    assert pa.batch_candidates(base, divisor, max_batch) == batch_candidates(
        base, divisor, max_batch)


def _measures():
    def linear(b):
        return 1000 + 100 * b

    def raises_at_16(b):
        if b >= 16:
            raise MemoryError("out of memory")
        return 1000 + 100 * b

    def never_fits(b):
        return 10 ** 9

    return {"linear": linear, "raises": raises_at_16, "never": never_fits}


@pytest.mark.parametrize("measure", ["linear", "raises", "never"])
@pytest.mark.parametrize("budget", [2000, 3000, 10 ** 6])
def test_autotune_and_report_match_jax(measure, budget):
    from heuristique_style_transfer_code_tpu.train.autotune import (
        autotune_batch,
        describe_report,
    )

    fn = _measures()[measure]
    cands = (4, 8, 16, 32, 64)
    want = autotune_batch(fn, budget, cands)
    got = pa.autotune_batch(fn, budget, cands)
    assert got == want
    assert pa.describe_report(got[1], budget) == describe_report(want[1], budget)


def test_device_hbm_is_none_on_the_cpu():
    assert pa.device_hbm_bytes("cpu") is None


@pytest.fixture(scope="module")
def f2_setup():
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention
    from heuristique_style_transfer_code_tpu_torch.train.mixing import make_mix_fn

    cfg = GramAttentionConfig(batch_size=4, lr=0.01, truncate_layer=5, gram_matrix_size=4)
    return setup_gram_attention(cfg, 4, [(None, None)], ema_decay=0.9,
                                mix_fn=make_mix_fn(0.2, 1.0), device="cpu")


def test_cpu_estimate_grows_with_the_batch_and_touches_no_generator(f2_setup):
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten

    before = (torch.get_rng_state(), np.random.get_state()[1].copy())
    init = _flatten(to_jax_tree(f2_setup.init(torch.Generator().manual_seed(9))[0]))
    peaks = [pa.train_step_peak_bytes(f2_setup, b, 256, "cpu") for b in (1, 2, 4)]
    assert peaks[0] < peaks[1] < peaks[2]
    # the staged batch alone, at least, grows by 256² x 3 bytes an image
    assert peaks[2] - peaks[1] >= 2 * 256 * 256 * 3
    assert torch.equal(torch.get_rng_state(), before[0])
    assert np.array_equal(np.random.get_state()[1], before[1])
    again = _flatten(to_jax_tree(f2_setup.init(torch.Generator().manual_seed(9))[0]))
    assert all(np.array_equal(init[k], again[k]) for k in init)


CFG = {"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4, "seed": 0}


@pytest.mark.parametrize("extra,message", [
    (("--auto_batch", "--hbm_budget_gb", "1", "--grad_accum", "2"),
     "--auto_batch is exclusive with --grad_accum>1 and --parallel_folds"),
    (("--auto_batch", "--hbm_budget_gb", "1", "--lr_schedule", "cosine"),
     "--lr_schedule/--warmup_steps are exclusive with --auto_batch"),
    (("--auto_batch", "--warmup_steps", "2"),
     "--lr_schedule/--warmup_steps are exclusive with --auto_batch"),
    (("--auto_batch",), "this backend does not report a memory budget; pass --hbm_budget_gb"),
    (("--auto_batch", "--hbm_budget_gb", "0.0001"), "even batch 4 exceeds the budget"),
])
def test_cli_refusals_keep_the_jax_messages(tiny_imagefolder, tmp_path, extra, message):
    from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main

    cfg = tmp_path / "cfg.json"
    with open(cfg, "w") as f:
        json.dump(CFG, f)
    with pytest.raises(SystemExit) as e:
        main(["--data", str(tiny_imagefolder), "--config_path", str(cfg), "--epochs", "1",
              "--save_dir", str(tmp_path / "out"), "--device", "cpu", *extra])
    assert message in str(e.value)
