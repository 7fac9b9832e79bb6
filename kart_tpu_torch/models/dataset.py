"""Datasets V3, read side: an immutable view of a dataset's git tree.

    <ds-path>/.table-dataset/
        meta/schema.json, meta/legend/<hash>, meta/title, meta/description,
        meta/crs/<id>.wkt, meta/path-structure.json, meta/capabilities.json
        feature/<encoded-path>      msgpack [legend-hash, [non-pk values]]
    <ds-path>/metadata.xml          "attachment" meta item

Counterpart of the read side of kart_tpu's ``models/dataset.py``
(``Dataset3``: meta items, ``get_crs_definition``, ``geom_column_name``,
``feature_tree``, ``inner_path``, ``path_encoder`` (the legacy hashed
layout when there is no ``path-structure.json``), ``feature_index``,
``decode_path_to_pks``, ``get_feature*``, ``get_feature_promise_from_oid``,
the fused JSON serialisers ``_json_value_str``, ``_jsonl_serializer`` and
``feature_json_str_from_data``; ``FeatureOidPromise``), ``encode_feature``
for ``kart resolve --with-file``, ``new_dataset_meta_blobs`` for new
datasets, and the write side of a commit: ``encode_meta_item`` and
``apply_diff`` (``apply_meta_diff``, ``apply_feature_diff``), which write a
dataset's diff through a tree builder with kart_tpu's conflict checks and
``PatchApplyError`` texts. ``Dataset2`` with ``dataset_class_for_version``
covers a V2 repository's ``.sno-dataset`` trees, read and written as V3
in the legacy hashed layout. ``features`` streams a dataset's features
(spatially filtered, promised blobs skipped) for a working copy's checkout.
"""

import json
from json.encoder import encode_basestring_ascii

import numpy as np

from kart_tpu_torch.core.odb import ObjectMissing, ObjectPromised, TreeView
from kart_tpu_torch.core.serialise import (
    ensure_bytes,
    ensure_text,
    json_pack,
    json_unpack,
    msg_unpack,
    msg_unpack_ext_raw,
)
from kart_tpu_torch.geometry import gpkg_hex_wkb
from kart_tpu_torch.models.paths import PathEncoder, encoder_for_schema
from kart_tpu_torch.models.schema import Legend, Schema

ATTACHMENT_META_ITEMS = ("metadata.xml",)


class NotYetImplemented(RuntimeError):
    """A repository structure version with no dataset class (kart_tpu's
    ``models.dataset.NotYetImplemented``: not a RepoError, so the CLI does
    not turn it into an exit code)."""


class DatasetCapabilityError(RuntimeError):
    """The dataset requires capabilities this port does not support."""


class FeatureOidPromise:
    """Zero-arg callable resolving a feature dict from its blob oid, with
    the oid and dataset open so writers can prefetch blob data in bulk
    into ``data``."""

    __slots__ = ("ds", "pk_values", "oid_hex", "data")

    def __init__(self, ds, pk_values, oid_hex):
        self.ds = ds
        self.pk_values = pk_values
        self.oid_hex = oid_hex
        self.data = None

    def __call__(self):
        data = self.data
        if data is None:
            data = self.ds._feature_odb().read_blob(self.oid_hex)
        else:
            self.data = None  # one-shot: free the bytes after decode
        return self.ds.get_feature(self.pk_values, data=data)


def _json_value_str(v, _float_repr=float.__repr__):
    """One scalar -> its JSON text, byte-identical to the stdlib encoder
    with ``separators=(",", ":"), ensure_ascii=True`` (exact-type checks:
    bool must not take the int branch)."""
    t = v.__class__
    if t is int:
        return str(v)
    if t is str:
        return encode_basestring_ascii(v)
    if t is float:
        if v == v and v not in (float("inf"), float("-inf")):
            return _float_repr(v)
        return "NaN" if v != v else ("Infinity" if v > 0 else "-Infinity")
    if t is bool:
        return "true" if v else "false"
    if t is bytes:
        return '"' + v.hex() + '"'
    return json.dumps(v, separators=(",", ":"), ensure_ascii=True)


class Dataset3:
    """A V3 dataset bound to its outer tree (the one at ``path``)."""

    VERSION = 3
    DATASET_DIRNAME = ".table-dataset"

    FEATURE_PATH = "feature/"
    META_PATH = "meta/"
    LEGEND_PATH = "meta/legend/"
    SCHEMA_PATH = "meta/schema.json"
    TITLE_PATH = "meta/title"
    DESCRIPTION_PATH = "meta/description"
    CRS_PATH = "meta/crs/"
    PATH_STRUCTURE_PATH = "meta/path-structure.json"

    def __init__(self, tree, path, repo=None):
        self.tree = tree
        self.path = path.strip("/")
        self.repo = repo
        self._meta_cache = {}
        self._json_plans = {}
        self._jsonl_fns = {}
        self._odb = None
        if self.inner_tree is not None:
            caps = self.get_meta_item("capabilities.json")
            if caps:
                raise DatasetCapabilityError(
                    f"Dataset {self.path} requires unsupported capabilities: {caps}"
                )

    @classmethod
    def is_dataset_tree(cls, tree):
        try:
            return tree.entry(cls.DATASET_DIRNAME).is_tree
        except KeyError:
            return False

    @property
    def inner_tree(self):
        if self.tree is None:
            return None
        node = self.tree.get_or_none(self.DATASET_DIRNAME)
        return node if isinstance(node, TreeView) else None

    @property
    def inner_path(self):
        return f"{self.path}/{self.DATASET_DIRNAME}"

    @property
    def feature_tree(self):
        inner = self.inner_tree
        return inner.get_or_none("feature") if inner is not None else None

    def feature_index(self):
        """One walk of the feature tree -> (paths list[str] relative to
        ``feature/``, pk int64 array or None, oid bytes (N, 20) uint8), in
        tree order. The pk array is None for a hash-keyed dataset: its
        identity is the hash of the filename, not a pk."""
        enc = self.path_encoder
        feature_tree = self.feature_tree
        if feature_tree is None:
            return [], None, np.zeros((0, 20), dtype=np.uint8)
        paths, oids = feature_tree.blob_columns()
        pk_arr = enc.decode_paths_batch(paths) if enc.scheme == "int" else None
        return paths, pk_arr, oids

    # -- meta items ----------------------------------------------------------

    def get_data_at(self, rel_path, missing_ok=False):
        """Raw bytes at a path relative to the inner tree."""
        inner = self.inner_tree
        node = inner.get_or_none(rel_path) if inner is not None else None
        if node is None or isinstance(node, TreeView):
            if missing_ok:
                return None
            raise KeyError(f"{self.path}/{self.DATASET_DIRNAME}/{rel_path}")
        return node.data

    def get_meta_item(self, name, missing_ok=True):
        """Decoded meta item: .json -> parsed, .wkt/text -> str, others raw."""
        if name in self._meta_cache:
            return self._meta_cache[name]
        if name in ATTACHMENT_META_ITEMS:
            data = None
            if self.tree is not None:
                node = self.tree.get_or_none(name)
                data = node.data if node is not None and not isinstance(node, TreeView) else None
        else:
            data = self.get_data_at(self.META_PATH + name, missing_ok=True)
            if data is None and not name.startswith("crs/"):
                data = self.get_data_at(name, missing_ok=True)
        if data is None:
            if not missing_ok:
                raise KeyError(f"No meta item: {name}")
            result = None
        elif name.endswith(".json"):
            result = json_unpack(data)
        elif name.endswith(".wkt") or name in ("title", "description", "metadata.xml"):
            result = ensure_text(data)
        else:
            result = data
        self._meta_cache[name] = result
        return result

    def meta_items(self):
        """dict of the standard meta items present."""
        out = {}
        for name in ("title", "description", "schema.json"):
            value = self.get_meta_item(name)
            if value is not None:
                out[name] = value
        for name in self.crs_identifiers():
            out[f"crs/{name}.wkt"] = self.get_meta_item(f"crs/{name}.wkt")
        value = self.get_meta_item("metadata.xml")
        if value is not None:
            out["metadata.xml"] = value
        return out

    def crs_identifiers(self):
        inner = self.inner_tree
        crs_tree = inner.get_or_none("meta/crs") if inner is not None else None
        if crs_tree is None:
            return []
        return [e.name[: -len(".wkt")] for e in crs_tree.entries() if e.name.endswith(".wkt")]

    def get_crs_definition(self, identifier=None):
        """The WKT of one of the dataset's CRSes (``identifier`` may be
        given as ``crs/<id>.wkt``); without one, the dataset must have
        exactly one."""
        ids = self.crs_identifiers()
        if identifier is None:
            if len(ids) != 1:
                raise ValueError(
                    f"Dataset {self.path} has {len(ids)} CRS definitions; specify one of {ids}"
                )
            identifier = ids[0]
        if identifier.startswith("crs/"):
            identifier = identifier[4:-4] if identifier.endswith(".wkt") else identifier[4:]
        return self.get_meta_item(f"crs/{identifier}.wkt")

    @property
    def geom_column_name(self):
        """The name of the first geometry column, or None."""
        col = self.schema.first_geometry_column
        return col.name if col else None

    @property
    def schema(self) -> Schema:
        if "__schema__" not in self._meta_cache:
            cols = self.get_meta_item("schema.json", missing_ok=False)
            self._meta_cache["__schema__"] = Schema.from_column_dicts(cols)
        return self._meta_cache["__schema__"]

    def get_legend(self, legend_hash) -> Legend:
        key = f"__legend__{legend_hash}"
        if key not in self._meta_cache:
            self._meta_cache[key] = Legend.loads(self.get_data_at(self.LEGEND_PATH + legend_hash))
        return self._meta_cache[key]

    @property
    def path_encoder(self) -> PathEncoder:
        """The dataset's feature path encoder: the one its
        ``path-structure.json`` names, or the legacy hashed layout when it
        has none."""
        if "__encoder__" not in self._meta_cache:
            spec = self.get_meta_item("path-structure.json")
            self._meta_cache["__encoder__"] = (
                PathEncoder.get(**spec) if spec is not None else PathEncoder.LEGACY_ENCODER)
        return self._meta_cache["__encoder__"]

    # -- feature reads -------------------------------------------------------

    def decode_path_to_pks(self, path):
        """feature blob path (or bare filename) -> pk value tuple."""
        return PathEncoder.decode_filename(path.rsplit("/", 1)[-1])

    def get_feature(self, pk_values=None, *, data=None):
        """-> feature dict keyed by column name, from raw blob data or by
        pk through the feature tree."""
        if data is None:
            rel = self.path_encoder.encode_pks_to_path(tuple(pk_values))
            data = self.get_data_at(self.FEATURE_PATH + rel)
        legend_hash, non_pk_values = msg_unpack(data)
        raw = self.get_legend(legend_hash).to_raw_dict(tuple(pk_values), tuple(non_pk_values))
        return self.schema.feature_from_raw_dict(raw)

    def get_feature_promise_from_oid(self, pk_values, oid_hex):
        return FeatureOidPromise(self, pk_values, oid_hex)

    def _feature_odb(self):
        if self._odb is None:
            tree = self.feature_tree
            self._odb = tree.odb if tree is not None else self.repo.odb
        return self._odb

    def _json_plan(self, legend_hash):
        """[(column name, (is_pk, value index) | None, is_geometry)] in
        schema order for one legend."""
        plan = self._json_plans.get(legend_hash)
        if plan is None:
            legend = self.get_legend(legend_hash)
            pk_pos = {cid: i for i, cid in enumerate(legend.pk_columns)}
            nonpk_pos = {cid: i for i, cid in enumerate(legend.non_pk_columns)}
            plan = []
            for c in self.schema.columns:
                if c.id in pk_pos:
                    src = (True, pk_pos[c.id])
                elif c.id in nonpk_pos:
                    src = (False, nonpk_pos[c.id])
                else:
                    src = None  # column added since this legend
                plan.append((c.name, src, c.data_type == "geometry"))
            self._json_plans[legend_hash] = plan
        return plan

    def feature_json_from_data(self, pk_values, data):
        """Feature blob bytes -> JSON-ready dict (geometry as upper-hex WKB,
        bytes as hex), equal to converting :meth:`get_feature`'s dict."""
        legend_hash, non_pk_values = msg_unpack_ext_raw(data)
        out = {}
        for name, src, is_geom in self._json_plan(legend_hash):
            v = None
            if src is not None:
                is_pk, i = src
                seq = pk_values if is_pk else non_pk_values
                if i < len(seq):
                    v = seq[i]
            if v is not None:
                if is_geom:
                    v = gpkg_hex_wkb(v)
                elif isinstance(v, bytes):
                    v = v.hex()
            out[name] = v
        return out

    def _jsonl_serializer(self, legend_hash):
        """Per-legend compiled serialiser ``fn(pk_values, non_pk_values) ->
        json object text``: the column plan unrolled into straight-line
        code. Every embedded literal goes through repr()."""
        fn = self._jsonl_fns.get(legend_hash)
        if fn is not None:
            return fn
        lines = [
            "def _ser(pk, vals, _str=str, _esc=_esc, _fr=_fr, _hex=_hex, _jvs=_jvs):",
            " np_ = len(pk)",
            " nv_ = len(vals)",
        ]
        parts = []
        for k, (name, src, is_geom) in enumerate(self._json_plan(legend_hash)):
            prefix = ("" if k == 0 else ",") + encode_basestring_ascii(name) + ":"
            if src is None:
                parts.append(repr(prefix + "null"))
                continue
            is_pk, i = src
            seq, bound = ("pk", "np_") if is_pk else ("vals", "nv_")
            lines.append(f" v{k} = {seq}[{i}] if {i} < {bound} else None")
            if is_geom:
                parts.append(
                    f"({prefix!r} + ('null' if v{k} is None else '\"' + _hex(v{k}) + '\"'))"
                )
            else:
                parts.append(
                    f"({prefix!r} + ('null' if v{k} is None else"
                    f" _str(v{k}) if v{k}.__class__ is int else"
                    f" _esc(v{k}) if v{k}.__class__ is str else"
                    f" _fr(v{k}) if v{k}.__class__ is float"
                    f" and v{k} == v{k} and -1e400 < v{k} < 1e400 else"
                    f" _jvs(v{k})))"
                )
        body = " + ".join(parts) if parts else "''"
        lines.append(f" return '{{' + {body} + '}}'")
        namespace = {"_esc": encode_basestring_ascii, "_fr": float.__repr__,
                     "_hex": gpkg_hex_wkb, "_jvs": _json_value_str}
        exec("\n".join(lines), namespace)
        fn = self._jsonl_fns[legend_hash] = namespace["_ser"]
        return fn

    def feature_json_str_from_data(self, pk_values, data):
        """Feature blob bytes -> the feature's compact JSON object text,
        byte-identical to encoding :meth:`feature_json_from_data` with
        ``separators=(",", ":"), ensure_ascii=True``."""
        legend_hash, non_pk_values = msg_unpack_ext_raw(data)
        fn = self._jsonl_fns.get(legend_hash) or self._jsonl_serializer(legend_hash)
        return fn(pk_values, non_pk_values)

    @property
    def feature_count(self):
        feature_tree = self.feature_tree
        return 0 if feature_tree is None else sum(1 for _ in feature_tree.walk_blobs())

    #: feature blobs :meth:`features` reads a batch
    FEATURE_READ_CHUNK = 10000

    def features(self, spatial_filter=None, skip_promised=False):
        """Every feature, in tree order, from one walk of the feature tree
        and batched blob reads. ``spatial_filter`` drops the features it
        does not match; with ``skip_promised`` a promised (out-of-filter)
        blob is skipped instead of raising."""
        feature_tree = self.feature_tree
        if feature_tree is None:
            return
        odb = feature_tree.odb
        paths, pk_arr, oids_u8 = self.feature_index()
        hexes = oids_u8.tobytes().hex()
        pks = pk_arr.tolist() if pk_arr is not None else None
        for start in range(0, len(paths), self.FEATURE_READ_CHUNK):
            stop = min(start + self.FEATURE_READ_CHUNK, len(paths))
            oids = [hexes[40 * i : 40 * i + 40] for i in range(start, stop)]
            batch = odb.read_blobs_batch(oids)
            absent = odb.absent([o for o in oids if o not in batch]) if skip_promised else ()
            promised = bool(absent) and odb._promisor_check()
            for i, oid in zip(range(start, stop), oids):
                if oid in absent:
                    if promised:
                        continue
                    raise odb._missing(oid)
                pk_values = (pks[i],) if pks is not None else self.decode_path_to_pks(paths[i])
                data = batch.get(oid)
                try:
                    if data is None:
                        data = odb.read_blob(oid)
                    feature = self.get_feature(pk_values, data=data)
                except ObjectPromised:
                    if skip_promised:
                        continue
                    raise
                if spatial_filter is not None and not spatial_filter.matches(feature):
                    continue
                yield feature

    def encode_feature(self, feature, schema=None, *, relative=False):
        """Name-keyed feature -> (its blob path, full or relative to the
        dataset's inner tree, blob bytes)."""
        schema = schema or self.schema
        pk_values, blob = schema.encode_feature_blob(feature)
        rel = self.FEATURE_PATH + self.path_encoder.encode_pks_to_path(pk_values)
        return (rel if relative else f"{self.inner_path}/{rel}", blob)

    @classmethod
    def new_dataset_meta_blobs(cls, path, schema, *, title=None, description=None,
                               crs_defs=None, path_encoder=None):
        """-> [(full_path, blob_bytes)] for a brand-new dataset's meta tree."""
        inner = f"{path.strip('/')}/{cls.DATASET_DIRNAME}"
        enc = path_encoder or encoder_for_schema(schema)
        blobs = [
            (f"{inner}/{cls.SCHEMA_PATH}", schema.dumps()),
            (f"{inner}/{cls.LEGEND_PATH}{schema.legend_hash}", schema.legend.dumps()),
        ]
        if enc is not PathEncoder.LEGACY_ENCODER:
            blobs.append((f"{inner}/{cls.PATH_STRUCTURE_PATH}", json_pack(enc.to_dict())))
        if title:
            blobs.append((f"{inner}/{cls.TITLE_PATH}", ensure_bytes(title)))
        if description:
            blobs.append((f"{inner}/{cls.DESCRIPTION_PATH}", ensure_bytes(description)))
        for ident, wkt in (crs_defs or {}).items():
            blobs.append((f"{inner}/{cls.CRS_PATH}{ident}.wkt", ensure_bytes(wkt)))
        return blobs

    def encode_meta_item(self, name, value):
        """Meta item name and value -> (full path, blob bytes, or None to
        delete it)."""
        if value is None:
            data = None
        elif name.endswith(".json"):
            data = json_pack(value)
        else:
            data = ensure_bytes(value)
        if name in ATTACHMENT_META_ITEMS:
            return (f"{self.path}/{name}", data)
        return (f"{self.inner_path}/{self.META_PATH}{name}", data)

    # -- applying diffs ------------------------------------------------------

    def apply_diff(self, ds_diff, tree_builder, *, allow_missing_old=False):
        """Write one dataset's DatasetDiff through ``tree_builder``, each
        delta's old value checked against this version first."""
        schema = self.apply_meta_diff(ds_diff.get("meta"), tree_builder,
                                      allow_missing_old=allow_missing_old)
        self.apply_feature_diff(ds_diff.get("feature"), tree_builder, schema=schema,
                                allow_missing_old=allow_missing_old)

    def apply_meta_diff(self, meta_diff, tree_builder, *, allow_missing_old=False):
        """-> the schema the dataset's features are encoded with after the
        meta diff: a new ``schema.json`` writes its legend too, and on a new
        dataset the path structure of its pk."""
        from kart_tpu_torch.core.structure import PatchApplyError

        schema = None if self.inner_tree is None else self.schema
        if not meta_diff:
            return schema
        for name, delta in meta_diff.items():
            if not allow_missing_old:
                current = self.get_meta_item(name) if self.inner_tree is not None else None
                if current != delta.old_value:
                    raise PatchApplyError(
                        f"Conflict at {self.path}:meta:{name} — "
                        f"value does not match the patch's old value")
            if name == "schema.json":
                if delta.new is None:
                    raise PatchApplyError(
                        f"Cannot delete schema of {self.path}; delete the dataset instead")
                new_schema = Schema.from_column_dicts(delta.new_value)
                if (schema is not None and not schema.is_pk_compatible(new_schema)
                        and self.feature_count):
                    raise NotYetImplemented(
                        "Schema changes that alter the primary key are not yet "
                        "supported on non-empty datasets")
                path, data = self.encode_meta_item(name, delta.new_value)
                tree_builder.insert(path, tree_builder.odb.write_blob(data))
                tree_builder.insert(
                    f"{self.inner_path}/{self.LEGEND_PATH}{new_schema.legend_hash}",
                    tree_builder.odb.write_blob(new_schema.legend.dumps()))
                if schema is None:
                    enc = encoder_for_schema(new_schema)
                    if enc is not PathEncoder.LEGACY_ENCODER:
                        tree_builder.insert(f"{self.inner_path}/{self.PATH_STRUCTURE_PATH}",
                                            tree_builder.odb.write_blob(json_pack(enc.to_dict())))
                    self._meta_cache["__encoder__"] = enc
                schema = new_schema
                continue
            path, data = self.encode_meta_item(name, delta.new_value)
            if data is None:
                tree_builder.remove(path)
            else:
                tree_builder.insert(path, tree_builder.odb.write_blob(data))
        return schema

    def apply_feature_diff(self, feature_diff, tree_builder, *, schema=None,
                           allow_missing_old=False):
        """Write a feature DeltaDiff: an old value must be the feature this
        version holds, and an insert must find no feature at its path."""
        from kart_tpu_torch.core.structure import PatchApplyError

        if not feature_diff:
            return
        schema = schema or self.schema
        odb = tree_builder.odb
        has_tree = self.feature_tree is not None
        for delta in feature_diff.values():
            old_pks = None
            if delta.old is not None:
                key = delta.old_key
                old_pks = schema.sanitise_pks(key if isinstance(key, (list, tuple)) else [key])
            old_path = self.encode_pks_to_path(old_pks) if old_pks is not None else None
            if not allow_missing_old and delta.old is not None:
                try:
                    current = self.get_feature(old_pks) if has_tree else None
                except (KeyError, ObjectMissing):
                    current = None
                if current != delta.old_value:
                    raise PatchApplyError(
                        f"Conflict at {self.path}:feature:{delta.old_key} — "
                        f"feature does not match the patch's old value")
            if delta.new is None:
                tree_builder.remove(old_path)
                continue
            pk_values, blob = schema.encode_feature_blob(delta.new_value)
            rel = self.path_encoder.encode_pks_to_path(pk_values)
            new_path = f"{self.inner_path}/{self.FEATURE_PATH}{rel}"
            if delta.old is None and not allow_missing_old and has_tree:
                if self.get_data_at(self.FEATURE_PATH + rel, missing_ok=True) is not None:
                    raise PatchApplyError(
                        f"Conflict at {self.path}:feature:{delta.new_key} — "
                        f"inserted feature already exists")
            if old_path is not None and old_path != new_path:
                tree_builder.remove(old_path)
            tree_builder.insert(new_path, odb.write_blob(blob))

    def encode_pks_to_path(self, pk_values):
        """pk values -> the feature's full blob path."""
        return (f"{self.inner_path}/{self.FEATURE_PATH}"
                f"{self.path_encoder.encode_pks_to_path(tuple(pk_values))}")

    def __repr__(self):
        return f"{type(self).__name__}({self.path!r})"


class Dataset2(Dataset3):
    """A legacy V2 dataset: another inner directory name and, with no
    ``path-structure.json``, the legacy hashed 256^2 feature paths."""

    VERSION = 2
    DATASET_DIRNAME = ".sno-dataset"


def dataset_class_for_version(version):
    """The dataset class of a repository structure version; any version
    but 2 and 3 raises :class:`NotYetImplemented`, as kart_tpu's does."""
    if version == 3:
        return Dataset3
    if version == 2:
        return Dataset2
    raise NotYetImplemented(
        f"Repo structure version {version} is not supported (supported: 2, 3)"
    )
