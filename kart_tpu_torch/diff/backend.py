"""The diff backend registry and kernel K2, the envelope prefilter scan
(``csrc/envelope_scan.cu``), with its plain PyTorch version.

Three backends, chosen by device and, on several cards, by rows:

* ``device_torch`` -- one CUDA device: uploads through pinned buffers and
  runs the kernels.
* ``sharded_torch`` -- the mesh of every visible card
  (:mod:`kart_tpu_torch.parallel`), kart_tpu's ``sharded_jax``: the
  classify with its key-aligned chunks dealt out over the devices
  (``diff_kernel.classify_blocks_streamed`` with a mesh: B3, and B8 for
  the estimation's sampled rows, at least one chunk a device), and the
  mesh forms of K2, K5, K6 and K7, each device on its own rows. A
  ``device_torch`` backend for the card asked for without an index hands
  each piece of work to it as kart_tpu's ``select_backend`` routes: when
  ``parallel.should_shard`` passes for the rows of that piece (2 or more
  cards, ``KART_SHARDED_MIN_ROWS``). With one card every route is
  ``device_torch``'s.
* ``cpu_torch`` -- the CPU: the diff's classify on the host floor, a copy
  of kart_tpu's native merge-join (``ops/host_classify.py``), the plain
  PyTorch versions of the other kernels, and numpy's host projection for
  the tile export.

A fourth, ``plain_torch``, runs the plain versions on any device; no command
selects it: it is what the kernels are held against on the card.

Below the sharding rule there are no row-count gates: a caller that asks
for the card gets the card, whatever the size, and a failure raises
instead of degrading to the host or to one card (kart_tpu's sharded
backend falls back to its host backend on any failure; the port's does
not). (At north-star scale the card streams the blocks through K1 in
chunks: ``diff_kernel.classify_blocks``.) Beside the diff's entry points, the query's: :meth:`join_counts`
(K5) and :meth:`refine_pairs` (K6); and the tile export's:
:meth:`merc_envelopes` (K7), reached through :func:`project_envelopes`.
"""

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import to_device
from kart_tpu_torch.ops.diff_kernel import classify_blocks, classify_blocks_streamed
from kart_tpu_torch.ops.envelope_join import (
    JoinLaunch,
    envelope_join,
    envelope_join_finish,
    envelope_join_launch,
    envelope_join_plain,
)
from kart_tpu_torch.ops.geom_refine import geom_refine, geom_refine_plain, resident_segments
from kart_tpu_torch.ops.host_classify import classify_blocks_host
from kart_tpu_torch.ops.merc import merc, merc_plain
from kart_tpu_torch.parallel.mesh import HostCopies, asks_for_mesh, make_mesh, on, shard_rows
from kart_tpu_torch.parallel.sharded_diff import STATS, should_shard

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

    def for_rows(self, n_rows):
        """The backend that work of ``n_rows`` rows runs on, decided once
        (the spatial join decides on its whole probe side): this one, but
        for a routable ``device_torch``."""
        return self

    def classify(self, old_block, new_block):
        """-> (old_class int8, new_class int8, counts int64 (3,)) tensors."""
        return classify_blocks(old_block, new_block, self.device)

    def counts(self, old_block, new_block):
        """Counts-only classify (`-o feature-count`, the estimation's
        sampled rows): no class arrays."""
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
    """One card. ``routable``: the card was asked for without an index, so
    each call hands its work to the mesh of every visible card when
    ``should_shard`` passes for the rows it was given (kart_tpu's
    ``select_backend`` rule), and otherwise runs it on this card."""

    name = "device_torch"

    def __init__(self, device, routable=False):
        super().__init__(device)
        self.routable = routable

    def for_rows(self, n_rows):
        if not self.routable:
            return self
        if should_shard(n_rows):
            return ShardedTorchBackend(make_mesh())
        return DeviceTorchBackend(self.device)

    def _on(self, n_rows):
        """Where a call on ``n_rows`` rows runs: :meth:`for_rows`'s
        backend when routable, else the one-card methods on this card."""
        return self.for_rows(n_rows) if self.routable else super()

    def classify(self, old_block, new_block):
        return self._on(max(old_block.count, new_block.count)).classify(old_block, new_block)

    def counts(self, old_block, new_block):
        return self._on(max(old_block.count, new_block.count)).counts(old_block, new_block)

    def envelope_hits(self, block, query):
        return self._on(block.count).envelope_hits(block, query)

    def refine_pairs(self, col_a, ia, col_b, ib):
        return self._on(len(ia)).refine_pairs(col_a, ia, col_b, ib)

    def merc_envelopes(self, env):
        return self._on(len(env)).merc_envelopes(env)


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


class ShardedTorchBackend(DiffBackend):
    """The mesh (a list of torch.devices, :mod:`kart_tpu_torch.parallel`):
    every device runs its own rows through the one-card kernels, and the
    results come back on the mesh's first device (``device``) or the host,
    as the one-card backend returns them. Where kart_tpu's sharded backend
    hands a case to its base class (a wrapping query rectangle, fewer
    envelopes than :data:`DEVICE_MIN_ENVELOPES`) this one hands it to the
    one-card route on the first device."""

    name = "sharded_torch"

    def __init__(self, mesh):
        self.mesh = list(mesh)
        super().__init__(self.mesh[0])

    def classify(self, old_block, new_block):
        """B3: the blocks' key-aligned chunks dealt out over the mesh, one
        K1 a chunk on its device."""
        STATS["sharded_classify_calls"] += 1
        return classify_blocks_streamed(old_block, new_block, self.device, mesh=self.mesh)

    def counts(self, old_block, new_block):
        """B3 counts-only; on an estimation's sampled rows B8: at most one
        key-aligned slice a device, one counts-only K1 each."""
        STATS["sharded_classify_calls"] += 1
        return classify_blocks_streamed(old_block, new_block, self.device, mesh=self.mesh,
                                        counts_only=True)[2]

    def envelope_hits(self, block, query):
        q = np.asarray(query, dtype=np.float64)
        if q[2] < q[0] or block.count < DEVICE_MIN_ENVELOPES:
            return super().envelope_hits(block, query)
        return sharded_envelope_hits(block.envelopes, block.count, q, self.mesh)

    def merc_envelopes(self, env):
        e = np.ascontiguousarray(env, dtype=np.float64).reshape(-1, 4)
        if len(e) < DEVICE_MIN_ENVELOPES:
            return super().merc_envelopes(e)
        return sharded_merc_envelopes(e, self.mesh)

    def join_counts(self, build_env, probe_env, pairs=False):
        return sharded_join_counts(build_env, probe_env, pairs, self.mesh)

    def refine_pairs(self, col_a, ia, col_b, ib):
        return sharded_refine_pairs(col_a, ia, col_b, ib, self.mesh)


class PlainTorchBackend(DiffBackend):
    """The plain versions of K2, K5, K6 and K7 on any device, the card
    included: what the query's kernels are checked against through the
    query's own loop, never a route of a command."""

    name = "plain_torch"
    plain = True


BACKENDS = {cls.name: cls for cls in (DeviceTorchBackend, ShardedTorchBackend, CpuTorchBackend)}


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
    DeviceUnavailable without one): ``device_torch`` for the card, routable
    to the mesh (``sharded_torch``) call by call when the card was asked for
    without an index, as kart_tpu's ``select_backend`` routes; an explicit
    ``cuda:N`` pins one card, ``"cpu"`` is the host floor."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        return BACKENDS["cpu_torch"](dev)
    return BACKENDS["device_torch"](dev, routable=asks_for_mesh(device))


# --- the mesh forms ----------------------------------------------------------------------

#: kart_tpu's ``KART_DEVICE_MIN_ENVELOPES`` default: below it its sharded
#: backend leaves the envelope scan and the projection to its base class
DEVICE_MIN_ENVELOPES = 1_000_000


def _pieces(n, mesh):
    """-> [(device, lo, hi)]: ``n`` rows cut into one contiguous piece a
    device of ``mesh``."""
    return [(d, lo, hi) for d, (lo, hi) in zip(mesh, shard_rows(n, len(mesh)))]


def sharded_envelope_hits(envelopes, count, query, mesh):
    """K2 over the mesh: the first ``count`` (n, 4) f32 envelope rows cut
    into one piece a device, each scanned there -> bool (count,) hits on the
    mesh's first device."""
    hits = []
    for device, lo, hi in _pieces(count, mesh):
        with on(device):
            env = to_device(np.asarray(envelopes[lo:hi], dtype=np.float32), device)
            hits.append(envelope_scan(env, query))
    return torch.cat([h.to(mesh[0]) for h in hits])


def sharded_merc_envelopes(env, mesh):
    """K7 over the mesh: (M, 4) f64 degrees cut into one piece a device ->
    (mx0, my0, mx1, my1) f64 host columns."""
    copies = HostCopies()
    for device, lo, hi in _pieces(len(env), mesh):
        with on(device):
            copies.add(merc(to_device(np.ascontiguousarray(env[lo:hi]), device)))
    cols = np.concatenate(copies.arrays(), axis=1)
    return cols[0], cols[1], cols[2], cols[3]


def sharded_join_counts(build_env, probe_env, pairs, mesh):
    """K5 over the mesh: the probe rows cut into one piece a device, the
    build tile copied to each device once, every device's counts pass
    enqueued before any pair total is read (one read a device), then the
    pairs passes. -> (counts int32 (B,), pair total, (probe rows, build
    rows) int32 in row-major order or None), on the mesh's first device."""
    home = mesh[0]
    builds = {}
    runs = []
    for device, lo, hi in _pieces(probe_env.shape[0], mesh):
        with on(device):
            if device not in builds:
                builds[device] = build_env.to(device)
            probe = probe_env[lo:hi].to(device)
            if device.type == "cuda":
                runs.append((lo, envelope_join_launch(builds[device], probe, pairs)))
            else:
                runs.append((lo, envelope_join_plain(builds[device], probe, pairs)))
    totals = [int(r.total.item()) if isinstance(r, JoinLaunch) else r[1] for _, r in runs]
    done = []
    for (lo, r), n in zip(runs, totals):
        if isinstance(r, JoinLaunch):
            with on(r.probe_env.device):
                r = envelope_join_finish(r, n)
        done.append((lo, r))
    counts = torch.cat([r[0].to(home) for _, r in done])
    if not pairs:
        return counts, sum(totals), None
    probe_rows = torch.cat([(r[2][0] + lo).to(home) for lo, r in done])
    build_rows = torch.cat([r[2][1].to(home) for _, r in done])
    return counts, sum(totals), (probe_rows, build_rows)


def sharded_refine_pairs(col_a, ia, col_b, ib, mesh):
    """K6 over the mesh: the candidate pairs cut into one piece a device,
    each device refining its pairs against its own resident segment tables
    -> bool (P,) verdicts on the mesh's first device."""
    ia = torch.as_tensor(np.asarray(ia, dtype=np.int64)) if isinstance(ia, np.ndarray) else ia
    ib = torch.as_tensor(np.asarray(ib, dtype=np.int64)) if isinstance(ib, np.ndarray) else ib
    verdicts = []
    for device, lo, hi in _pieces(ia.numel(), mesh):
        with on(device):
            verdicts.append(geom_refine(
                resident_segments(col_a, device), ia[lo:hi].to(device),
                resident_segments(col_b, device), ib[lo:hi].to(device)))
    return torch.cat([v.to(mesh[0]) for v in verdicts])
