"""The device mesh: an ordered list of ``torch.device``s.

Counterpart of kart_tpu's ``parallel/mesh.py``. kart_tpu drives its mesh
from one process with ``shard_map`` and ``pmap``; the port keeps that
shape: one process holds the list and runs each shard's work on its own
device's current stream. By default the mesh is every visible card; the
CPU tests list ``torch.device("cpu")`` S times, and one card may be listed
S times to run a mesh's program on it.
"""

import contextlib

import numpy as np
import torch

from kart_tpu_torch import runtime

def best_device_count(limit=None):
    """Cards for a new mesh: every visible card (0 without CUDA),
    optionally capped."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if limit is not None:
        n = min(n, limit)
    return n


def make_mesh(n_devices=None, devices=None):
    """-> the mesh: ``devices`` as a list of torch.devices, or the first
    ``n_devices`` visible cards (default: all of them). Raises
    DeviceUnavailable when no card is visible and no devices are given."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = best_device_count()
    if n_devices < 1 or best_device_count() < n_devices:
        raise runtime.DeviceUnavailable(
            f"a mesh of {n_devices} card(s) asked for, {best_device_count()} visible")
    return [torch.device("cuda", i) for i in range(n_devices)]


def asks_for_mesh(device):
    """Whether a device request may be served by the mesh: the card asked
    for without an index (``None`` or ``"cuda"``). ``"cuda:N"`` pins card
    N and ``"cpu"`` is the host."""
    if device is None:
        return True
    dev = torch.device(device)
    return dev.type == "cuda" and dev.index is None


def on(device):
    """Make ``device`` the thread's current CUDA device for a shard's work
    (the launchers set it and do not restore it); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_rows(n, n_shards):
    """Contiguous row ranges of ``n`` rows over ``n_shards`` shards, the
    first ones one row longer. -> [(lo, hi), ...], one a shard."""
    cuts = [(s * n) // n_shards for s in range(n_shards + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


class HostCopies:
    """Device tensors copied into host memory: each copy is enqueued on its
    device's current stream (into pinned memory for a card) as it is
    added, and :meth:`arrays` waits once for each device, after every copy
    was enqueued."""

    def __init__(self):
        self.items = []
        self.events = []

    def add(self, tensor):
        if tensor.device.type == "cpu":
            self.items.append(tensor)
            return
        with on(tensor.device):
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(tensor.device))
        self.items.append(host)
        self.events.append(done)

    def arrays(self):
        """-> the copies as numpy arrays, in the order they were added."""
        for done in self.events:
            done.synchronize()
        self.events = []
        return [np.asarray(t.numpy()) for t in self.items]
