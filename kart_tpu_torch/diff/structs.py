"""Diff data model: a copy of kart_tpu's ``diff/structs.py``.

A diff is a nested structure:

    RepoDiff: {dataset-path: DatasetDiff}
    DatasetDiff: {"meta": DeltaDiff, "feature": DeltaDiff}
    DeltaDiff: {key: Delta}
    Delta: (old KeyValue | None) -> (new KeyValue | None)

Values are *lazy*: a KeyValue may carry a thunk instead of a materialised
value, so a 100M-feature diff can classify changes (via oids / the columnar
engine) without decoding a single feature blob until a writer asks for the
value. Deltas form a small algebra — concatenation (``delta1 + delta2``
composes consecutive edits, raising Conflict on impossible sequences) and
inversion (``~delta``) — which the working-copy and merge machinery relies on.
"""


class Conflict(Exception):
    """Two deltas cannot be concatenated (eg insert after insert)."""


# Flag: this delta came from working-copy edits, not committed history
# (reference: diff_structs.py:43-44).
WORKING_COPY_EDIT = 0x1


class KeyValue(tuple):
    """An (key, value) pair; value may be a zero-arg callable evaluated on
    first access (reference: diff_structs.py:12-40)."""

    @staticmethod
    def of(obj):
        if obj is None or isinstance(obj, KeyValue):
            return obj
        key, value = obj
        return KeyValue((key, value))

    def __new__(cls, item):
        return super().__new__(cls, item)

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        value = self[1]
        if callable(value):
            # memoize on the instance dict (tuple subclasses have one)
            try:
                return self.__dict__["_resolved"]
            except KeyError:
                resolved = value()
                self.__dict__["_resolved"] = resolved
                return resolved
        return value

    def get_lazy_value(self):
        return self.value

    @property
    def value_is_lazy(self):
        """True when the value is a thunk that has not been forced yet."""
        return callable(self[1]) and "_resolved" not in self.__dict__

    def __eq__(self, other):
        if not isinstance(other, tuple) or len(other) != 2:
            return NotImplemented
        other = KeyValue.of(other)
        return self.key == other.key and self.value == other.value

    def __hash__(self):
        return hash(self.key)

    def __repr__(self):
        return f"KeyValue({self.key!r}, {'<lazy>' if callable(self[1]) else self[1]!r})"


class Delta:
    """One change: insert / update / delete of a keyed value
    (reference: diff_structs.py:47-188)."""

    __slots__ = ("old", "new", "flags")

    def __init__(self, old, new, flags=0):
        self.old = KeyValue.of(old)
        self.new = KeyValue.of(new)
        self.flags = flags
        if self.old is None and self.new is None:
            raise ValueError("Delta must have at least one side")

    @classmethod
    def insert(cls, new, flags=0):
        return cls(None, new, flags)

    @classmethod
    def update(cls, old, new, flags=0):
        return cls(old, new, flags)

    @classmethod
    def delete(cls, old, flags=0):
        return cls(old, None, flags)

    @property
    def type(self):
        if self.old is None:
            return "insert"
        if self.new is None:
            return "delete"
        return "update"

    @property
    def old_key(self):
        return self.old.key if self.old is not None else None

    @property
    def new_key(self):
        return self.new.key if self.new is not None else None

    @property
    def key(self):
        """The key this delta is filed under: old key wins, so a rename
        sorts at its ORIGINAL position (reference: diff_structs.py:137-140)."""
        return self.old_key if self.old is not None else self.new_key

    @property
    def old_value(self):
        return self.old.value if self.old is not None else None

    @property
    def new_value(self):
        return self.new.value if self.new is not None else None

    def __invert__(self):
        return Delta(self.new, self.old, self.flags)

    def __add__(self, other):
        """Compose consecutive edits on the same key
        (reference: diff_structs.py:142-180)."""
        if not isinstance(other, Delta):
            return NotImplemented
        if self.new_key != other.old_key and not (
            self.new is None and other.old is None
        ):
            raise Conflict("Sequential deltas don't line up")
        if self.new is None and other.old is not None:
            raise Conflict("Delete followed by update")
        if self.new is not None and other.old is None and other.new is not None:
            raise Conflict("Insert on an existing key")
        old, new = self.old, other.new
        if old is None and new is None:
            # insert then delete: nothing happened
            return None
        return Delta(old, new, self.flags | other.flags)

    @property
    def is_noop(self):
        """True when old and new are both present with equal values
        — forces lazy values."""
        if self.old is None or self.new is None:
            return False
        return self.old_key == self.new_key and self.old_value == self.new_value

    def __eq__(self, other):
        if not isinstance(other, Delta):
            return NotImplemented
        return self.old == other.old and self.new == other.new

    def __hash__(self):
        return hash((self.old_key, self.new_key))

    def __repr__(self):
        return f"Delta[{self.type}]({self.old_key!r} -> {self.new_key!r})"


class RichDict(dict):
    """dict with recursive helpers and a child type
    (reference: diff_structs.py:191-260)."""

    child_type = None

    def recursive_len(self):
        total = 0
        for v in self.values():
            if isinstance(v, RichDict):
                total += v.recursive_len()
            else:
                total += 1
        return total

    def recursive_get(self, keys):
        node = self
        for k in keys:
            node = node[k]
        return node

    def recursive_set(self, keys, value):
        node = self
        for k in keys[:-1]:
            if k not in node:
                node[k] = node.child_type() if node.child_type else type(self)()
            node = node[k]
        node[keys[-1]] = value

    def create_empty_child(self, key):
        child = self.child_type()
        self[key] = child
        return child

    def prune(self, recurse=True):
        """Remove empty children (and no-op deltas in DeltaDiff)."""
        for k in list(self.keys()):
            v = self[k]
            if isinstance(v, RichDict):
                if recurse:
                    v.prune()
                if not v:
                    del self[k]
        return self

    def __invert__(self):
        out = type(self)()
        for k, v in self.items():
            out[k] = ~v
        return out


class DeltaDiff(RichDict):
    """{key: Delta} for one item-type of one dataset
    (reference: diff_structs.py:263-388)."""

    def __init__(self, deltas=()):
        super().__init__()
        if isinstance(deltas, dict):
            deltas = deltas.values()
        for d in deltas:
            self.add_delta(d)

    def add_delta(self, delta):
        if delta is None:
            return
        self[delta.key] = delta

    def __invert__(self):
        return DeltaDiff(~d for d in self.values())

    def __add__(self, other):
        result = DeltaDiff(self.values())
        result += other
        return result

    def __iadd__(self, other):
        """Concatenate a later diff onto this one, key by key."""
        for key, delta in other.items():
            existing = self.get(delta.old_key if delta.old is not None else key)
            if existing is not None:
                combined = existing + delta
                # the combined delta may be filed under a different key
                del self[existing.key]
                if combined is not None:
                    self[combined.key] = combined
            else:
                self[key] = delta
        return self

    def prune(self, recurse=True):
        """Drop no-op deltas. Deltas whose values are still-lazy thunks are
        never forced here: lazy deltas come from content-addressed compares
        (differing oids), so their values are already known to differ."""
        for k in list(self.keys()):
            d = self[k]
            if d.old is None or d.new is None:
                continue
            if d.old.value_is_lazy or d.new.value_is_lazy:
                continue
            if d.is_noop:
                del self[k]
        return self

    def type_counts(self):
        counts = {}
        for d in self.values():
            counts[d.type] = counts.get(d.type, 0) + 1
        return {k + "s": v for k, v in counts.items()}

    def sorted_items(self):
        def sort_key(item):
            k = item[0]
            return (0, k) if isinstance(k, (int, float)) else (1, str(k))

        return sorted(self.items(), key=sort_key)


class DatasetDiff(RichDict):
    """{"meta": DeltaDiff, "feature": DeltaDiff}
    (reference: diff_structs.py:391-440)."""

    child_type = DeltaDiff

    @classmethod
    def concatenated(cls, *diffs):
        result = cls()
        for d in diffs:
            if d is None:
                continue
            for part, delta_diff in d.items():
                if part in result:
                    result[part] += delta_diff
                else:
                    result[part] = DeltaDiff(delta_diff.values())
        return result

    def type_counts(self):
        return {part: dd.type_counts() for part, dd in self.items()}


class RepoDiff(RichDict):
    """{dataset-path: DatasetDiff} (reference: diff_structs.py:443-481)."""

    child_type = DatasetDiff

    def type_counts(self):
        return {path: ds.type_counts() for path, ds in self.items()}

    def feature_count(self):
        return sum(len(ds.get("feature", ())) for ds in self.values())
