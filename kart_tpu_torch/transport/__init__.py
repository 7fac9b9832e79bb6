"""Object exchange between repositories: clone, fetch, push and pull over
local remotes (paths and ``file://`` URLs), the shallow clone, the
spatially filtered partial clone with its promisor remote, and the fetch of
promised blobs on demand. Objects travel in the kartpack stream
(:mod:`.pack`); what a transfer ships is decided by a want/have walk
(:mod:`.protocol`).

Counterpart of kart_tpu's ``transport`` package, with its ``__all__`` less
the network lanes (HTTP, ssh/stdio, the server and the retry policy), which
are not ported.
"""

from kart_tpu_torch.transport.pack import read_pack, write_pack
from kart_tpu_torch.transport.protocol import ObjectEnumerator
from kart_tpu_torch.transport.remote import (
    Remote,
    RemoteError,
    add_remote,
    clone,
    fetch,
    fetch_promised_blobs,
    open_remote,
    push,
    remove_remote,
)

__all__ = [
    "Remote",
    "RemoteError",
    "add_remote",
    "remove_remote",
    "clone",
    "fetch",
    "push",
    "fetch_promised_blobs",
    "open_remote",
    "ObjectEnumerator",
    "read_pack",
    "write_pack",
]
