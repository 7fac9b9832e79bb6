"""Working copies: a mutable database mirror of one commit's datasets.

The GeoPackage working copy (:mod:`.gpkg`, stdlib ``sqlite3``) is the one
every non-bare repository gets by default. A ``postgresql:``, ``mssql:`` or
``mysql:`` location is a server-database working copy (:mod:`.postgis`,
:mod:`.sqlserver`, :mod:`.mysql` on :mod:`.db_server`), reached through
the server's DBAPI driver.

Counterpart of kart_tpu's ``workingcopy/__init__.py``: ``WorkingCopyType``,
``WorkingCopyStatus``, ``Mismatch``, ``can_find_renames``, ``find_renames``,
``checkout_features``, ``get_working_copy`` and ``default_location``.
"""

import os
from enum import Enum, IntFlag

from kart_tpu_torch.core.repo import InvalidOperation


class WorkingCopyType(Enum):
    GPKG = "gpkg"
    POSTGIS = "postgis"
    SQL_SERVER = "sqlserver"
    MYSQL = "mysql"

    @classmethod
    def from_location(cls, location):
        location = str(location)
        if location.startswith("postgresql:"):
            return cls.POSTGIS
        if location.startswith("mssql:"):
            return cls.SQL_SERVER
        if location.startswith("mysql:"):
            return cls.MYSQL
        if location.lower().endswith(".gpkg"):
            return cls.GPKG
        raise InvalidOperation(
            f"Unrecognised working copy location: {location!r} "
            f"(expected a .gpkg path or a postgresql://, mssql://, mysql:// URL)"
        )


class Mismatch(InvalidOperation):
    """The working copy holds another tree than the repository expects."""

    def __init__(self, wc_tree, expected_tree):
        super().__init__(
            f"Working copy is out of sync with repository: working copy has tree "
            f"{wc_tree}, repository expects {expected_tree}. "
            f'Use "kart checkout --force HEAD" to reset the working copy.'
        )


class WorkingCopyStatus(IntFlag):
    UNCONNECTABLE = 0x1
    NON_EXISTENT = 0x2
    CREATED = 0x4
    INITIALISED = 0x8
    HAS_DATA = 0x10
    DIRTY = 0x20


#: the most insert and delete deltas rename detection hashes
MAX_RENAME_SEARCH = 400


def can_find_renames(dataset, meta_diff):
    """Rename detection holds while the schema is unchanged but for type
    widths."""
    if meta_diff is None or "schema.json" not in meta_diff:
        return True
    delta = meta_diff["schema.json"]
    if delta.old_value is None or delta.new_value is None:
        return False
    from kart_tpu_torch.models.schema import Schema

    old_schema = Schema.from_column_dicts(delta.old_value)
    new_schema = Schema.from_column_dicts(delta.new_value)
    counts = dict(old_schema.diff_type_counts(new_schema))
    counts.pop("type_updates", None)
    return sum(counts.values()) == 0


def find_renames(feature_diff, dataset):
    """Pair an insert and a delete whose features are equal but for the pk
    into one update, in place: a pk edited in the working copy then shows
    as ``--- ds:feature:old`` / ``+++ ds:feature:new``. One pair a content
    hash, and only when there are at most :data:`MAX_RENAME_SEARCH`
    candidates."""
    from kart_tpu_torch.diff.structs import Delta

    candidates = [d for d in feature_diff.values() if d.type in ("insert", "delete")]
    if not candidates or len(candidates) > MAX_RENAME_SEARCH:
        return
    schema = dataset.schema
    inserts, deletes = {}, {}
    for delta in candidates:
        if delta.type == "insert":
            inserts[schema.hash_feature(delta.new_value, without_pk=True)] = delta
        else:
            deletes[schema.hash_feature(delta.old_value, without_pk=True)] = delta
    for h, delete_delta in deletes.items():
        insert_delta = inserts.get(h)
        if insert_delta is None:
            continue
        del feature_diff[delete_delta.key]
        del feature_diff[insert_delta.key]
        feature_diff.add_delta(Delta(delete_delta.old, insert_delta.new, flags=delete_delta.flags))


def checkout_features(repo, ds):
    """The features a working copy holds: the repo's spatial filter
    applied, and promised (out-of-filter) blobs skipped."""
    from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec

    spec = ResolvedSpatialFilterSpec.from_repo_config(repo)
    sf = spec.resolve_for_dataset(ds)
    return ds.features(spatial_filter=sf if sf else None,
                       skip_promised=repo.has_promisor_remote())


def get_working_copy(repo, allow_uncreated=False, device=None):
    """-> the repository's working copy, or None when it has no location
    (a bare repository) or, unless ``allow_uncreated``, nothing is
    initialised there. ``device`` is where its non-force resets classify
    (None: the card)."""
    from kart_tpu_torch.core.repo import KartConfigKeys

    location = repo.config.get(KartConfigKeys.KART_WORKINGCOPY_LOCATION)
    if location is None and not repo.is_bare:
        location = default_location(repo)
    if location is None:
        return None
    wc_type = WorkingCopyType.from_location(location)
    if wc_type is WorkingCopyType.GPKG:
        from kart_tpu_torch.workingcopy.gpkg import GpkgWorkingCopy as wc_class
    elif wc_type is WorkingCopyType.POSTGIS:
        from kart_tpu_torch.workingcopy.postgis import PostgisWorkingCopy as wc_class
    elif wc_type is WorkingCopyType.SQL_SERVER:
        from kart_tpu_torch.workingcopy.sqlserver import SqlServerWorkingCopy as wc_class
    else:
        from kart_tpu_torch.workingcopy.mysql import MySqlWorkingCopy as wc_class
    wc = wc_class(repo, location, device=device)
    if not allow_uncreated and not (wc.status() & WorkingCopyStatus.INITIALISED):
        return None
    return wc


def default_location(repo):
    """``<workdir name>.gpkg`` in the workdir, or None for a bare repo."""
    if repo.workdir is None:
        return None
    return f"{os.path.basename(repo.workdir) or 'data'}.gpkg"
