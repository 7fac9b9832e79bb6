"""PyTorch/CUDA port of kart_tpu's columnar diff hot path.

The package runs the device half of ``kart diff`` on an NVIDIA Hopper card:
the sort-free classify join (``ops.diff_kernel``), the envelope prefilter
(``diff.backend``) and the cyclic-longitude bbox pre-pass of spatially
filtered clones (``ops.bbox``), each a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside it. It reads the on-disk
state kart_tpu writes (columnar sidecars, the envelope index) byte for byte
and imports nothing of kart_tpu or JAX.

Every entry point takes ``device``: ``None`` means ``cuda:0`` and raises
:class:`~kart_tpu_torch.runtime.DeviceUnavailable` without a card;
``device="cpu"`` runs the plain versions.
"""

__version__ = "0.1.0"
