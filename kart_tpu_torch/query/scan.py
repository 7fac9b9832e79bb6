"""Predicate-pushdown scans over one commit.

A ``--where``/``--bbox`` predicate runs in stages, each cheaper than the
next and each shrinking the rows the next one pays for:

1. the bbox: K2 over the sidecar's envelope column (the block aggregates'
   all-out/all-in classes are counted in the stats), then, unless
   ``--approx``, K6 against the rectangle's polygon for the candidates with
   usable geometry (the rest keep their envelope verdict);
2. predicates on a single int pk, vectorized over the key column;
3. the other predicates, on the feature blobs of the survivors, read in
   ordered batches (``KART_QUERY_BATCH_ROWS``).

``count``, ``count by <col>`` and the bbox union build no rows; ``-o json``
decodes only the page asked for.

Counterpart of kart_tpu's ``query/scan.py``: the ``--where`` grammar
(``_tokenize``, :class:`Predicate`, :func:`compile_where`),
:func:`parse_bbox`, the stages, the envelope and vertex fallbacks for
sidecars without those columns, and :func:`run_scan`, whose documents are
byte for byte kart_tpu's.
"""

import os
import re

import numpy as np

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.query import QueryError, _bump, load_query_dataset, resolve_query_commit

#: candidate feature blobs per ordered decode batch (stage 3); also the
#: spatial join's probe batch
DEFAULT_BATCH_ROWS = 65536

#: default rows of a JSON result page
DEFAULT_PAGE_SIZE = 1000

#: the most rows a page may ask for
MAX_PAGE_SIZE = 100_000


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def batch_rows():
    return max(_env_int("KART_QUERY_BATCH_ROWS", DEFAULT_BATCH_ROWS), 1)


def page_size_default():
    return max(_env_int("KART_QUERY_PAGE_SIZE", DEFAULT_PAGE_SIZE), 1)


# --- the predicate grammar -----------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<op><=|>=|<>|!=|==|=|<|>)
    | (?P<lpar>\() | (?P<rpar>\)) | (?P<comma>,)
    | (?P<str>'(?:[^']|'')*')
    | (?P<num>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
    | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
    )""",
    re.VERBOSE,
)

_OP_ALIASES = {"==": "=", "<>": "!="}


def _tokenize(text):
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == m.start():
            rest = text[pos:].strip()
            if not rest:
                break
            raise QueryError(f"cannot parse --where near {rest[:30]!r}")
        pos = m.end()
        kind = m.lastgroup
        tok = m.group(kind)
        if kind == "str":
            tok = tok[1:-1].replace("''", "'")
        elif kind == "num":
            tok = float(tok) if re.search(r"[.eE]", m.group(kind)) else int(tok)
        elif kind == "op":
            tok = _OP_ALIASES.get(tok, tok)
        tokens.append((kind, tok))
    return tokens


class Predicate:
    """One clause of an AND-joined ``--where``: a typed comparison, an IN
    set, or an IS [NOT] NULL test on a schema column."""

    __slots__ = ("col", "kind", "op", "value", "values", "on_pk")

    def __init__(self, col, kind, op=None, value=None, values=None, on_pk=False):
        self.col = col
        self.kind = kind  # "cmp" | "in" | "isnull" | "notnull"
        self.op = op
        self.value = value
        self.values = values
        self.on_pk = on_pk  # evaluated over the key column

    def matches(self, v):
        if self.kind == "isnull":
            return v is None
        if self.kind == "notnull":
            return v is not None
        if v is None:
            return False  # NULL compares to nothing
        if self.kind == "in":
            return v in self.values
        op = self.op
        if op == "=":
            return v == self.value
        if op == "!=":
            return v != self.value
        if op == "<":
            return v < self.value
        if op == "<=":
            return v <= self.value
        if op == ">":
            return v > self.value
        return v >= self.value

    def matches_keys(self, keys):
        """:meth:`matches` over the int64 pk column."""
        if self.kind == "isnull":
            return np.zeros(len(keys), dtype=bool)
        if self.kind == "notnull":
            return np.ones(len(keys), dtype=bool)
        if self.kind == "in":
            return np.isin(keys, np.asarray(sorted(self.values), dtype=np.int64))
        ops = {
            "=": np.equal, "!=": np.not_equal,
            "<": np.less, "<=": np.less_equal,
            ">": np.greater, ">=": np.greater_equal,
        }
        return ops[self.op](keys, np.int64(self.value))


def _typed_literal(col, tok_kind, tok):
    dt = col.data_type
    if dt == "integer":
        if tok_kind != "num" or isinstance(tok, float):
            raise QueryError(f"--where: column {col.name!r} is integer, got {tok!r}")
        return int(tok)
    if dt in ("float", "numeric"):
        if tok_kind != "num":
            raise QueryError(f"--where: column {col.name!r} is {dt}, got {tok!r}")
        return float(tok)
    if dt == "boolean":
        if tok_kind == "word" and str(tok).lower() in ("true", "false"):
            return str(tok).lower() == "true"
        raise QueryError(f"--where: column {col.name!r} is boolean, use true/false")
    if dt == "geometry":
        raise QueryError(f"--where: column {col.name!r} is geometry — use --bbox")
    if tok_kind != "str":
        raise QueryError(
            f"--where: column {col.name!r} ({dt}) needs a 'quoted' literal, got {tok!r}")
    return str(tok)


def compile_where(where, schema):
    """``--where`` text + the dataset's schema -> [Predicate], AND-joined.
    Raises QueryError on a grammar error, an unknown column or a literal of
    the wrong type."""
    if not where or not where.strip():
        return []
    cols = {c.name: c for c in schema.columns}
    pk_names = {
        c.name for c in schema.pk_columns
        if c.data_type == "integer" and len(schema.pk_columns) == 1
    }
    toks = _tokenize(where)
    preds, i = [], 0

    def _need(kind, what):
        nonlocal i
        if i >= len(toks) or toks[i][0] != kind:
            got = toks[i][1] if i < len(toks) else "end of input"
            raise QueryError(f"--where: expected {what}, got {got!r}")
        tok = toks[i][1]
        i += 1
        return tok

    while i < len(toks):
        name = _need("word", "a column name")
        col = cols.get(name)
        if col is None:
            raise QueryError(f"--where: no column {name!r} (have: {', '.join(cols)})")
        if i < len(toks) and toks[i][0] == "word" and str(toks[i][1]).upper() in ("IS", "IN"):
            kw = str(toks[i][1]).upper()
            i += 1
            if kw == "IS":
                negate = False
                if i < len(toks) and str(toks[i][1]).upper() == "NOT":
                    negate, i = True, i + 1
                if i >= len(toks) or str(toks[i][1]).upper() != "NULL":
                    raise QueryError("--where: expected NULL after IS")
                i += 1
                preds.append(Predicate(name, "notnull" if negate else "isnull",
                                       on_pk=name in pk_names))
            else:  # IN ( lit, lit, ... )
                _need("lpar", "'(' after IN")
                values = set()
                while True:
                    if i >= len(toks) or toks[i][0] not in ("num", "str", "word"):
                        raise QueryError("--where: expected a literal in IN (...)")
                    values.add(_typed_literal(col, toks[i][0], toks[i][1]))
                    i += 1
                    if i < len(toks) and toks[i][0] == "comma":
                        i += 1
                        continue
                    break
                _need("rpar", "')' closing IN")
                preds.append(Predicate(name, "in", values=values, on_pk=name in pk_names))
        else:
            op = _need("op", "a comparison operator")
            if i >= len(toks) or toks[i][0] not in ("num", "str", "word"):
                raise QueryError(f"--where: expected a literal after {op}")
            value = _typed_literal(col, toks[i][0], toks[i][1])
            i += 1
            preds.append(Predicate(name, "cmp", op=op, value=value, on_pk=name in pk_names))
        if i < len(toks):
            kw = toks[i]
            if kw[0] != "word" or str(kw[1]).upper() != "AND":
                raise QueryError(f"--where: expected AND between clauses, got {kw[1]!r}")
            i += 1
            if i >= len(toks):
                raise QueryError("--where: dangling AND")
    return preds


def parse_bbox(text):
    """``W,S,E,N`` -> (4,) f64; E < W wraps the anti-meridian."""
    try:
        parts = [float(p) for p in str(text).split(",")]
    except ValueError:
        raise QueryError(f"--bbox: expected W,S,E,N numbers, got {text!r}") from None
    if len(parts) != 4:
        raise QueryError(f"--bbox: expected 4 values, got {len(parts)}")
    w, s, e, n = parts
    if s > n:
        raise QueryError(f"--bbox: S ({s}) > N ({n})")
    if not all(np.isfinite(parts)):
        raise QueryError("--bbox: values must be finite")
    return np.asarray(parts, dtype=np.float64)


# --- the scan --------------------------------------------------------------------

def _read_blobs(ds, block, rows):
    """The feature blobs of block rows ``rows``, in order: bytes, or None
    for a blob that no pack holds (promised, absent or loose: kart_tpu's
    ordered read serves packs only)."""
    from kart_tpu_torch.ops.blocks import unpack_oid_bytes

    return ds._feature_odb().packs.read_blob_data_ordered(
        unpack_oid_bytes(np.asarray(block.oids[rows])))


def _load_block(repo, ds, ds_path):
    from kart_tpu_torch.diff import sidecar

    block = sidecar.ensure_block(repo, ds)
    if block is None:
        raise QueryError(f"cannot build a columnar index for {ds_path!r}")
    if block.envelopes is None and ds.geom_column_name is not None and block.count:
        block = _with_fallback_envelopes(ds, block)
    return block


def _with_fallback_envelopes(ds, block):
    """Envelope columns for a sidecar without them: one pass over the
    feature blobs in block row order (a NULL or unreadable geometry gets
    the whole world)."""
    from kart_tpu_torch.diff.sidecar import AGG_BLOCK_ROWS, block_aggregates, _feature_envelope_wsen
    from kart_tpu_torch.ops.blocks import FeatureBlock

    geom_col = ds.geom_column_name
    n = block.count
    envs = np.empty((n, 4), dtype=np.float32)
    rows = batch_rows()
    for lo in range(0, n, rows):
        datas = _read_blobs(ds, block, slice(lo, min(lo + rows, n)))
        for i, data in enumerate(datas):
            if data is None:
                raise QueryError(
                    "feature blob missing (promised/partial clone) —"
                    " cannot derive envelopes for a spatial predicate")
            pks = _pks_for_index(block, ds, lo + i)
            envs[lo + i] = _feature_envelope_wsen(ds.get_feature(pks, data=data), geom_col)
    agg, flags = block_aggregates(envs, AGG_BLOCK_ROWS)
    return FeatureBlock(block.keys, block.oids, n, envelopes=envs,
                        env_blocks=(agg, flags, AGG_BLOCK_ROWS), paths=block.paths)


def _with_fallback_vertices(ds, block):
    """The vertex column of a sidecar without one: one pass over the
    feature blobs in block row order; a missing blob or an unreadable
    geometry gives a kind-0 row, which keeps its envelope verdict."""
    from kart_tpu_torch.geom import vertex_column_from_blobs

    geom_col = ds.geom_column_name
    n = block.count
    rows = batch_rows()
    blobs = []
    for lo in range(0, n, rows):
        datas = _read_blobs(ds, block, slice(lo, min(lo + rows, n)))
        for i, data in enumerate(datas):
            if data is None:
                blobs.append(None)
                continue
            pks = _pks_for_index(block, ds, lo + i)
            g = ds.get_feature(pks, data=data).get(geom_col)
            blobs.append(bytes(g) if g is not None else None)
    col = vertex_column_from_blobs(blobs)
    block._vertices = col
    return col


def vertices_for_block(ds, block):
    """The refine stage's geometry: the sidecar's vertex column, else the
    one read from the blobs; None without a geometry column (every verdict
    stays at its envelope)."""
    col = block.vertex_column()
    if col is not None:
        return col
    if ds.geom_column_name is None or not block.count:
        return None
    return _with_fallback_vertices(ds, block)


def _pks_for_index(block, ds, i):
    if block.paths is None:  # an int-pk sidecar: the key is the pk
        return (int(block.keys[i]),)
    return ds.decode_path_to_pks(block.path_for_index(i))


def _prune_stats(block, query, stats):
    """The block classes of the query, for the stats document, when the
    sidecar has block aggregates and ``KART_BLOCK_PRUNE`` is not 0."""
    from kart_tpu_torch.ops.bbox import BLOCK_ALL_IN, BLOCK_ALL_OUT, classify_env_blocks_np

    if block.env_blocks is None or os.environ.get("KART_BLOCK_PRUNE", "1") == "0":
        return
    agg, flags, _block_rows = block.env_blocks
    cls = classify_env_blocks_np(agg, flags, query)
    stats["blocks"] = int(len(cls))
    stats["blocks_pruned"] = int(np.count_nonzero(cls == BLOCK_ALL_OUT))
    stats["blocks_all_in"] = int(np.count_nonzero(cls == BLOCK_ALL_IN))


def _bbox_indices(block, query, stats, backend):
    if block.envelopes is None:
        raise QueryError(
            "--bbox needs an envelope column (no geometry in this dataset's sidecar)")
    if block.count:
        hits = backend.envelope_hits(block, query).cpu().numpy()
    else:
        hits = np.zeros(0, dtype=bool)
    _prune_stats(block, query, stats)
    return np.flatnonzero(hits).astype(np.int64)


def _refine_bbox_indices(ds, block, idx, query, stats, backend, refine_hook=None):
    """Exact-refine the envelope candidates against the rectangle's polygon
    (K6). Kind-0 rows, anti-meridian features and a wrapping rectangle keep
    their envelope verdicts, so the survivors are a subset of the hits."""
    from kart_tpu_torch.geom import bbox_vertex_column

    qcol = bbox_vertex_column(query)
    if qcol is None or not len(idx):
        return idx
    col = vertices_for_block(ds, block)
    if col is None:
        return idx
    env = np.asarray(block.envelopes)[idx]
    usable = col.usable()[idx] & ~(env[:, 2] < env[:, 0])
    cand = np.flatnonzero(usable)
    if not len(cand):
        return idx
    if refine_hook is not None:
        refine_hook()
    verdict = backend.refine_pairs(col, idx[cand], qcol,
                                   np.zeros(len(cand), dtype=np.int64)).cpu().numpy()
    keep = np.ones(len(idx), dtype=bool)
    keep[cand] = verdict
    stats["pairs_refined"] += int(len(cand))
    stats["refine_dropped"] += int(np.count_nonzero(~verdict))
    return idx[keep]


def _feature_values(ds, block, idx, stats, scan_hook=None):
    """Ordered batches of (row, JSON-ready feature dict) for the rows
    ``idx``. Raises QueryError on a blob no pack holds (a partial clone
    cannot answer value predicates)."""
    rows = batch_rows()
    for lo in range(0, len(idx), rows):
        if scan_hook is not None:
            scan_hook()
        sel = idx[lo : lo + rows]
        out = []
        for j, data in zip(sel.tolist(), _read_blobs(ds, block, sel)):
            if data is None:
                raise QueryError(
                    "feature blob missing (promised/partial clone) — value"
                    " predicates need local blobs")
            out.append((j, ds.feature_json_from_data(_pks_for_index(block, ds, j), data)))
        stats["rows_decoded"] += len(out)
        yield out


def _filter_rows(ds, block, idx, preds, stats, scan_hook=None):
    """Stages 2 and 3: the pk predicates over the keys, then the rest over
    the blobs."""
    pk_preds = [p for p in preds if p.on_pk]
    blob_preds = [p for p in preds if not p.on_pk]
    if pk_preds and len(idx):
        keys = np.asarray(block.keys[idx])
        mask = np.ones(len(idx), dtype=bool)
        for p in pk_preds:
            mask &= p.matches_keys(keys)
        idx = idx[mask]
    if blob_preds and len(idx):
        keep = []
        for batch in _feature_values(ds, block, idx, stats, scan_hook):
            for j, feature in batch:
                if all(p.matches(feature.get(p.col)) for p in blob_preds):
                    keep.append(j)
        idx = np.asarray(keep, dtype=np.int64)
    return idx


def _bbox_union(block, idx):
    """Union wsen of the rows' envelopes: a wrapping member widens it to
    every longitude; NaN (NULL geometry) members are skipped."""
    if block.envelopes is None:
        raise QueryError("bbox aggregate needs an envelope column")
    env = np.asarray(block.envelopes[idx], dtype=np.float64)
    env = env[np.isfinite(env).all(axis=1)]
    if not len(env):
        return None
    w = float(np.min(env[:, 0]))
    s = float(np.min(env[:, 1]))
    e = float(np.max(env[:, 2]))
    n = float(np.max(env[:, 3]))
    if np.any(env[:, 2] < env[:, 0]):
        w, e = -180.0, 180.0
    return [w, s, e, n]


def _count_by(ds, block, idx, col_name, stats, scan_hook=None):
    """``count by <col>`` -> {rendered value: count}, sorted by the rendered
    value; a single int pk groups over the keys, anything else over the
    blobs."""
    cols = {c.name: c for c in ds.schema.columns}
    col = cols.get(col_name)
    if col is None:
        raise QueryError(f"count by: no column {col_name!r}")
    if col.data_type == "geometry":
        raise QueryError("count by: grouping on geometry is not supported")
    pk_cols = ds.schema.pk_columns
    if len(pk_cols) == 1 and pk_cols[0].name == col_name and col.data_type == "integer":
        values, counts = np.unique(np.asarray(block.keys[idx]), return_counts=True)
        groups = {str(int(v)): int(c) for v, c in zip(values, counts)}
    else:
        groups = {}
        for batch in _feature_values(ds, block, idx, stats, scan_hook):
            for _j, feature in batch:
                v = feature.get(col_name)
                key = "null" if v is None else str(v)
                groups[key] = groups.get(key, 0) + 1
    return dict(sorted(groups.items()))


def _page(page, page_size):
    """-> (page, page size): the size defaults to ``KART_QUERY_PAGE_SIZE``
    and is clamped to [1, MAX_PAGE_SIZE]; a negative page is page 0."""
    ps = max(min(int(page_size) if page_size else page_size_default(), MAX_PAGE_SIZE), 1)
    return max(int(page or 0), 0), ps


def run_scan(repo, refish, ds_path, *, where=None, bbox=None, output="count", count_by=None,
             page=None, page_size=None, approx=False, backend):
    """The pushdown scan behind ``kart query`` -> the JSON-ready result
    document. ``approx=True`` (or ``KART_GEOM_REFINE=0``) skips the exact
    refine: verdicts stop at the envelopes."""
    from kart_tpu_torch.geom import geom_refine_enabled

    if output not in ("count", "json", "bbox"):
        raise QueryError(f"unknown output {output!r} (count, json, bbox)")
    commit_oid = resolve_query_commit(repo, refish)
    ds = load_query_dataset(repo, commit_oid, ds_path)
    preds = compile_where(where, ds.schema)
    query = parse_bbox(bbox) if bbox is not None else None
    block = _load_block(repo, ds, ds_path)
    n = block.count
    exact = query is not None and not approx and geom_refine_enabled()
    scan_hook = faults.hook("query.scan")
    refine_hook = faults.hook("query.refine")
    stats = {
        "rows": int(n),
        "blocks": 0,
        "blocks_pruned": 0,
        "blocks_all_in": 0,
        "rows_scanned": 0,
        "rows_decoded": 0,
        "pairs_refined": 0,
        "refine_dropped": 0,
    }
    if scan_hook is not None:
        scan_hook()
    if query is not None:
        idx = _bbox_indices(block, query, stats, backend)
        if exact:
            idx = _refine_bbox_indices(ds, block, idx, query, stats, backend, refine_hook)
    else:
        idx = np.arange(n, dtype=np.int64)
    stats["rows_scanned"] = int(len(idx))
    if preds:
        idx = _filter_rows(ds, block, idx, preds, stats, scan_hook)

    result = {
        "kind": "scan",
        "commit": commit_oid,
        "dataset": ds_path,
        "where": where or None,
        "bbox": [float(v) for v in query] if query is not None else None,
        "exact": exact,
        "count": int(len(idx)),
        "stats": stats,
    }
    if count_by is not None:
        result["groups"] = _count_by(ds, block, idx, count_by, stats, scan_hook)
    elif output == "bbox":
        result["bbox_union"] = _bbox_union(block, idx)
    elif output == "json":
        pg, ps = _page(page, page_size)
        features = []
        for batch in _feature_values(ds, block, idx[pg * ps : (pg + 1) * ps], stats,
                                     scan_hook):
            features.extend(f for _j, f in batch)
        result["features"] = features
        result["page"] = pg
        result["page_size"] = ps
        result["next_page"] = pg + 1 if (pg + 1) * ps < len(idx) else None

    tm.incr("query.scans")
    tm.incr("query.blocks_pruned", stats["blocks_pruned"])
    tm.incr("query.rows_scanned", stats["rows_scanned"])
    tm.incr("query.pairs_refined", stats["pairs_refined"])
    _bump("scans")
    _bump("blocks_pruned", stats["blocks_pruned"])
    _bump("rows_scanned", stats["rows_scanned"])
    _bump("pairs_refined", stats["pairs_refined"])
    _bump("refine_dropped", stats["refine_dropped"])
    return result
