"""The tiny linear "model" of tests/linear_serving.py on the PyTorch port,
for the port's serving and recycling suites.

The same weights (one flat matmul over CROP² RGB crops), in a module that
imports torch and the port only: the recycling tests' spawned workers
build their batcher from it and import no JAX.
"""
import threading
from concurrent.futures import Future

import numpy as np
import torch

CROP = 32
CLASSES = 4
UNSENDABLE = 7  # a frame of this value everywhere gets a reply that does not pickle


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.RandomState(0)  # the draws of linear_serving.linear_variables
        self.w = torch.nn.Parameter(
            torch.from_numpy(rng.randn(CROP * CROP * 3, CLASSES).astype(np.float32) * 0.01))
        self.b = torch.nn.Parameter(torch.from_numpy(rng.randn(CLASSES).astype(np.float32)))


def linear_forward(model, images):
    return images.reshape(images.shape[0], -1) @ model.w + model.b


class _Replies:
    """The batcher, but a frame of UNSENDABLE everywhere resolves at once
    with a value that does not pickle (a lock)."""

    def __init__(self, batcher):
        self._batcher = batcher

    def submit(self, frame):
        frame = np.asarray(frame)
        if frame.dtype == np.uint8 and frame.size and np.all(frame == UNSENDABLE):
            fut = Future()
            fut.set_result(threading.Lock())
            return fut
        return self._batcher.submit(frame)

    def __getattr__(self, name):
        return getattr(self._batcher, name)


def recycling_builder(argv):
    """In-child builder for the RecyclingServiceProxy tests: the linear
    batcher on the CPU (batch 4, an inner queue of 4). Its ready info gives
    no ``max_queue``. argv: optional [max_delay_ms]."""
    from heuristique_style_transfer_code_tpu_torch.tasks.serving import (
        BatchingInferenceServer,
    )

    torch.set_num_threads(1)
    delay = float(argv[0]) if argv else 5.0
    batcher = BatchingInferenceServer(
        linear_forward, Linear(), batch_size=4, max_delay_ms=delay, crop=CROP, max_queue=4,
    ).start()
    return _Replies(batcher), {"crop": CROP, "count_key": "images",
                               "class_names": ["a", "b", "c", "d"]}
