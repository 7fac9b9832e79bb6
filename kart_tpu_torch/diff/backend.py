"""The diff backend registry and kernel K2, the envelope prefilter scan
(``csrc/envelope_scan.cu``), with its plain PyTorch version.

Two backends, chosen by device only:

* ``device_torch`` -- a CUDA device: uploads through pinned buffers and
  runs the kernels.
* ``cpu_torch`` -- the CPU: the diff's classify on the host floor, a copy
  of kart_tpu's native merge-join (``ops/host_classify.py``), the plain
  PyTorch versions of the other kernels, and numpy's host projection for
  the tile export.

A third, ``plain_torch``, runs the plain versions on any device; no command
selects it: it is what the kernels are held against on the card.

There are no row-count gates: a caller that asks for the card gets the
card, whatever the size, and a failure raises instead of degrading to the
host. (At north-star scale the card streams the blocks through K1 in
chunks: ``diff_kernel.classify_blocks``.) Beside the diff's entry points, the query's: :meth:`join_counts`
(K5) and :meth:`refine_pairs` (K6); and the tile export's:
:meth:`merc_envelopes` (K7), reached through :func:`project_envelopes`.
"""

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import to_device
from kart_tpu_torch.ops.diff_kernel import classify_blocks
from kart_tpu_torch.ops.envelope_join import envelope_join, envelope_join_plain
from kart_tpu_torch.ops.geom_refine import geom_refine, geom_refine_plain, resident_segments
from kart_tpu_torch.ops.host_classify import classify_blocks_host
from kart_tpu_torch.ops.merc import merc, merc_plain

_SIGNATURES = {
    "kart_envelope_scan": [
        _build.P, _build.I64, _build.F32, _build.F32, _build.F32, _build.F32,
        _build.I32, _build.F64, _build.F64, _build.F64, _build.F64,
        _build.P, _build.I32, _build.I32, _build.P,
    ]
}


def query_f32_thresholds(query_f64):
    """Exact f64-equivalent f32 thresholds, as the native scan's
    make_query_f32 computes them: (double)x <= b <=> x <= largest_float_le(b),
    and symmetrically for >=. -> (qw_ge, qs_ge, qe_le, qn_le) float32."""
    q = np.asarray(query_f64, dtype=np.float64)
    f = q.astype(np.float32)
    back = f.astype(np.float64)
    ge = np.where(back < q, np.nextafter(f, np.float32(np.inf)), f)
    le = np.where(back > q, np.nextafter(f, np.float32(-np.inf)), f)
    return np.asarray([ge[0], ge[1], le[2], le[3]], dtype=np.float32)


def envelope_scan(envelopes, query):
    """(n, 4) f32 wsen rows + f64 query rect (w, s, e, n) -> bool (n,) hits,
    on the rows' device: bit-identical to the native
    ``sf_bbox_intersects_f32``. CUDA tensors run K2; CPU tensors run
    :func:`envelope_scan_plain`."""
    if (envelopes.dtype != torch.float32 or envelopes.dim() != 2
            or envelopes.shape[1] != 4 or not envelopes.is_contiguous()):
        raise ValueError("envelope_scan: envelopes must be contiguous f32 (n, 4)")
    q = np.asarray(query, dtype=np.float64)
    device = envelopes.device
    if device.type == "cpu":
        return envelope_scan_plain(envelopes, q)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"envelope_scan: unsupported device {device}")
    n = envelopes.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return out
    if envelopes.data_ptr() % 16:
        raise ValueError("envelope_scan: envelope rows must be 16-byte aligned")
    qf = query_f32_thresholds(q)
    lib = _build.load_library("envelope_scan", device, _SIGNATURES)
    rc = lib.kart_envelope_scan(
        envelopes.data_ptr(), n, *(float(v) for v in qf), int(q[2] < q[0]),
        *(float(v) for v in q), out.data_ptr(),
        _build.grid_blocks(device, n), device.index, _build.stream_ptr(device),
    )
    _build.check(lib, rc, "envelope_scan")
    runtime.count("envelope_scan_launches")
    return out


def envelope_scan_plain(envelopes, query):
    """Plain PyTorch version of K2 (any device)."""
    q = np.asarray(query, dtype=np.float64)
    w, s, e, n = envelopes.unbind(dim=1)
    if not q[2] < q[0]:
        qw, qs, qe, qn = (float(v) for v in query_f32_thresholds(q))
        lat = (s <= qn) & (qs <= n)
        a = w <= qe
        b = qw <= e
        wrap = e < w
        return lat & ((a & b) | (wrap & (a | b)))
    w, s, e, n = (c.double() for c in (w, s, e, n))
    qw, qs, qe, qn = torch.tensor(q, dtype=torch.float64, device=envelopes.device).unbind()
    lat = ~((s > qn) | (qs > n))
    len1 = torch.where(e >= w, e - w, _mod360(e - w))
    len2 = torch.where(qe >= qw, qe - qw, _mod360(qe - qw))
    return lat & ((_mod360(qw - w) <= len1) | (_mod360(w - qw) <= len2))


def _mod360(x):
    """The native mod360: truncating division through int64, then one
    +360 for negative remainders."""
    d = x - 360.0 * torch.trunc(x / 360.0)
    return torch.where(d < 0, d + 360.0, d)


class DiffBackend:
    """One execution layer on one device."""

    name = None
    plain = False

    def __init__(self, device):
        self.device = device

    def classify(self, old_block, new_block):
        """-> (old_class int8, new_class int8, counts int64 (3,)) tensors."""
        return classify_blocks(old_block, new_block, self.device)

    def counts(self, old_block, new_block):
        """Counts-only classify (`-o feature-count`): no class arrays."""
        return classify_blocks(old_block, new_block, self.device, counts_only=True)[2]

    def envelope_hits(self, block, query):
        """bool (count,) envelope-vs-query hits of one sidecar block."""
        env = to_device(np.asarray(block.envelopes[: block.count], dtype=np.float32),
                        self.device)
        return (envelope_scan_plain if self.plain else envelope_scan)(env, query)

    def join_counts(self, build_env, probe_env, pairs=False):
        """The spatial join's batch step: (T, 4) build x (B, 4) probe f32
        envelope tensors on this device -> (per-probe counts int32 (B,),
        pair total, the pairs in row-major order when ``pairs``)."""
        return (envelope_join_plain if self.plain else envelope_join)(build_env, probe_env, pairs)

    def refine_pairs(self, col_a, ia, col_b, ib):
        """The exact refine: candidate pairs over two vertex columns (int64
        index tensors or arrays) -> bool (P,) verdicts on this device. The
        columns' segment tables stay on the device between calls."""
        ia = to_device(np.asarray(ia, dtype=np.int64), self.device) if isinstance(
            ia, np.ndarray) else ia
        ib = to_device(np.asarray(ib, dtype=np.int64), self.device) if isinstance(
            ib, np.ndarray) else ib
        return (geom_refine_plain if self.plain else geom_refine)(
            resident_segments(col_a, self.device), ia, resident_segments(col_b, self.device), ib)

    def merc_envelopes(self, env):
        """(M, 4) f64 wsen degrees -> (mx0, my0, mx1, my1) f64 host columns
        of the normalized mercator projection, computed on this device (an
        empty batch launches nothing)."""
        e = to_device(np.ascontiguousarray(env, dtype=np.float64).reshape(-1, 4), self.device)
        cols = (merc_plain if self.plain else merc)(e).cpu().numpy()
        return cols[0], cols[1], cols[2], cols[3]


class DeviceTorchBackend(DiffBackend):
    name = "device_torch"


class CpuTorchBackend(DiffBackend):
    name = "cpu_torch"

    def classify(self, old_block, new_block):
        """The host floor: kart_tpu's native merge-join, built with g++."""
        return classify_blocks_host(old_block, new_block)

    def counts(self, old_block, new_block):
        return classify_blocks_host(old_block, new_block)[2]

    def merc_envelopes(self, env):
        """numpy's host projection, the one the tile quantizer patches
        against (kart_tpu's CPU backend projects with it too)."""
        return host_merc_envelopes(env)


class PlainTorchBackend(DiffBackend):
    """The plain versions of K2, K5, K6 and K7 on any device, the card
    included: what the query's kernels are checked against through the
    query's own loop, never a route of a command."""

    name = "plain_torch"
    plain = True


BACKENDS = {cls.name: cls for cls in (DeviceTorchBackend, CpuTorchBackend)}


def host_merc_envelopes(env):
    """(M, 4) f64 wsen degrees -> numpy's (mx0, my0, mx1, my1) mercator
    columns on the host."""
    from kart_tpu_torch.tiles.clip import _host_merc

    return _host_merc(np.asarray(env, dtype=np.float64).reshape(-1, 4))


def project_envelopes(env, allow_device=True, device=None):
    """(M, 4) f64 wsen degrees -> (mx0, my0, mx1, my1) normalized-mercator
    f64 columns: the tile export's projection of one encode batch. With
    ``allow_device`` it runs on ``device`` (None: the card, K7; ``"cpu"``:
    numpy on the host); without it, numpy on the host as well, as the
    pool's workers run it (they never touch a device). Whichever ran, the
    tile quantizer makes the exported integers the host's."""
    if not allow_device:
        return host_merc_envelopes(env)
    return select_backend(device).merc_envelopes(env)


def select_backend(device=None):
    """The backend for ``device`` (``None`` = the card; raises
    DeviceUnavailable without one)."""
    dev = runtime.resolve_device(device)
    return BACKENDS["device_torch" if dev.type == "cuda" else "cpu_torch"](dev)
