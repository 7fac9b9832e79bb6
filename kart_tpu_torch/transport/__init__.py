"""Object exchange between repositories: clone, fetch, push and pull over
local remotes (paths and ``file://`` URLs), ``http(s)://`` servers and ssh
remotes; the shallow clone, the spatially filtered partial clone with its
promisor remote, and the fetch of promised blobs on demand. Objects travel
in the kartpack stream (:mod:`.pack`); what a transfer ships is decided by
a want/have walk (:mod:`.protocol`). The servers: :mod:`.http` (``kart
serve``) and :mod:`.stdio` (``kart serve-stdio``, the far end of an ssh
remote), both on the verbs of :mod:`.service`; :mod:`.retry` is the
clients' retry policy and the salvaging drain of the resumable fetch.

Counterpart of kart_tpu's ``transport`` package, with its ``__all__``.
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
