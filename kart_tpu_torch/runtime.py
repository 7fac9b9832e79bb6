"""Device resolution and launch counters.

Counterpart of kart_tpu's ``runtime.jax_ready``/``default_backend``, with
one difference of policy: nothing here probes and falls back. ``None``
means the card, a missing card raises :class:`DeviceUnavailable`, and the
CPU (the plain PyTorch versions) is reached only by asking for it.
"""

import threading

import torch

#: the only compute capability the kernels are built for (sm_90a)
SUPPORTED_CAPABILITY = (9, 0)


class DeviceUnavailable(RuntimeError):
    """The requested device cannot run this package's kernels."""


def resolve_device(device=None):
    """``None`` -> ``cuda:0``; ``"cpu"`` -> the CPU; any CUDA device must
    exist. Never quietly returns the CPU for a CUDA request."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceUnavailable(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"{dev} requested but CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions"
        )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise DeviceUnavailable(
            f"{dev} requested but only {torch.cuda.device_count()} CUDA device(s)"
        )
    return torch.device("cuda", index)


def check_capability(device):
    """Raise unless ``device`` is an sm_90 card (the kernels are sm_90a)."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != SUPPORTED_CAPABILITY:
        raise DeviceUnavailable(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap}; the kernels are built for sm_90a {SUPPORTED_CAPABILITY}"
        )


#: one counter per kernel launch (plus the resident-column uploads of the
#: bbox cache, the rows the envelope prefilter keeps a side, and the hash
#: collisions that sent a dataset to the host path), so a run can show
#: which kernels the main path went through
STATS = {
    "classify_launches": 0,
    "classify_counts_only_launches": 0,  # the subset of K1 launches in counts-only mode
    "envelope_scan_launches": 0,
    "bbox_launches": 0,
    "bbox_uploads": 0,
    "merge_classify_launches": 0,
    "envelope_join_launches": 0,
    "geom_refine_launches": 0,
    "merc_launches": 0,
    "prefilter_old_survivors": 0,
    "prefilter_new_survivors": 0,
    # kart_tpu's own semantics where hash keys collide: a diff or a merge of
    # a hash-keyed dataset that took the host path instead of the columnar
    # one (a second semantic path, not a fallback from a kernel)
    "hash_collision_fallbacks": 0,
}
_stats_lock = threading.Lock()


def count(name, n=1):
    with _stats_lock:
        STATS[name] += n


def reset_stats():
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


def stats_snapshot():
    with _stats_lock:
        return dict(STATS)
