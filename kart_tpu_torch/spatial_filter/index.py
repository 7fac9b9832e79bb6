"""Read-only access to the feature envelope index,
``<gitdir>/feature_envelopes.db``: a sqlite table of 20-byte blob oid ->
10-byte packed EPSG:4326 envelope (:mod:`kart_tpu_torch.ops.envelope_codec`).
kart_tpu builds and updates the index; this port only reads it.
"""

import os
import sqlite3

import numpy as np

from kart_tpu_torch.ops.envelope_codec import EnvelopeCodec

DB_NAME = "feature_envelopes.db"


def db_path(gitdir):
    return os.path.join(gitdir, DB_NAME)


class EnvelopeIndexReader:
    """Read-only access to the envelope table."""

    def __init__(self, path):
        self.path = path
        self.con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.codec = EnvelopeCodec()
        tables = {
            r[0]
            for r in self.con.execute("SELECT name FROM sqlite_master WHERE type = 'table'")
        }
        # early kart_tpu builds named the table 'blobs'; read it where it is
        self.table = "blobs" if "feature_envelopes" not in tables and "blobs" in tables \
            else "feature_envelopes"

    @classmethod
    def open(cls, gitdir):
        """The reader for the repo at ``gitdir``, or None without an index."""
        path = db_path(gitdir)
        if not os.path.exists(path):
            return None
        return cls(path)

    def all_envelopes(self):
        """-> (oids list[str], (N,4) float64 wsen array), in the table's
        key order."""
        rows = self.con.execute(f"SELECT blob_id, envelope FROM {self.table}").fetchall()
        oids = [r[0].hex() for r in rows]
        if not rows:
            return oids, np.empty((0, 4))
        packed = np.frombuffer(b"".join(r[1] for r in rows), dtype=np.uint8).reshape(
            len(rows), -1
        )
        return oids, self.codec.decode_batch(packed)

    def close(self):
        self.con.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
