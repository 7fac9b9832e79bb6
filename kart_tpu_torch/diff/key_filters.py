"""Filters restricting which datasets/features an operation touches: a
copy of kart_tpu's ``diff/key_filters.py``.

User patterns look like ``datasetpath`` or ``datasetpath:pk`` or
``datasetpath:feature:pk``. A filter is a nested structure mirroring RepoDiff:
repo -> dataset -> item-type -> keys, with a MATCH_ALL sentinel at any level.
"""


class _MatchAll:
    def __contains__(self, key):
        return True

    def __bool__(self):
        return True

    def __repr__(self):
        return "<MATCH_ALL>"


MATCH_ALL = _MatchAll()


class FeatureKeyFilter:
    """A set of pk strings (everything matches when match_all)."""

    def __init__(self, match_all=False):
        self.match_all = match_all
        self.keys = set()

    def add(self, key):
        self.keys.add(str(key))

    def __contains__(self, key):
        if self.match_all:
            return True
        if isinstance(key, (list, tuple)):
            key = key[0] if len(key) == 1 else tuple(key)
        return str(key) in self.keys

    def __bool__(self):
        return self.match_all or bool(self.keys)

    def __len__(self):
        return len(self.keys)


class DatasetKeyFilter:
    """item-type ('feature' / 'meta') -> FeatureKeyFilter."""

    def __init__(self, match_all=False):
        self.match_all = match_all
        self._parts = {}

    def get(self, part, default=None):
        if self.match_all:
            return FeatureKeyFilter(match_all=True)
        return self._parts.get(part, default)

    def __getitem__(self, part):
        got = self.get(part)
        if got is None:
            return FeatureKeyFilter(match_all=False)
        return got

    def ensure(self, part):
        if part not in self._parts:
            self._parts[part] = FeatureKeyFilter()
        return self._parts[part]

    def __bool__(self):
        return self.match_all or any(bool(v) for v in self._parts.values())


class RepoKeyFilter:
    """dataset-path -> DatasetKeyFilter."""

    def __init__(self, match_all=False):
        self.match_all = match_all
        self._datasets = {}

    @classmethod
    def MATCH_ALL_FILTER(cls):
        return cls(match_all=True)

    @classmethod
    def build_from_user_patterns(cls, patterns):
        """['ds', 'ds:123', 'ds:feature:123'] -> RepoKeyFilter. Empty
        patterns -> match-all."""
        patterns = [p for p in (patterns or []) if p]
        if not patterns:
            return cls(match_all=True)
        result = cls()
        for pattern in patterns:
            parts = pattern.split(":")
            ds_path = parts[0].strip("/")
            ds_filter = result._datasets.get(ds_path)
            if ds_filter is None:
                ds_filter = DatasetKeyFilter()
                result._datasets[ds_path] = ds_filter
            if len(parts) == 1:
                ds_filter.match_all = True
            elif len(parts) == 2:
                ds_filter.ensure("feature").add(parts[1])
            else:
                part_name = parts[1] or "feature"
                ds_filter.ensure(part_name).add(":".join(parts[2:]))
        return result

    def __contains__(self, ds_path):
        if self.match_all:
            return True
        return ds_path.strip("/") in self._datasets

    def get(self, ds_path):
        if self.match_all:
            return DatasetKeyFilter(match_all=True)
        return self._datasets.get(ds_path.strip("/"), DatasetKeyFilter())

    def __getitem__(self, ds_path):
        return self.get(ds_path)

    def ds_paths(self):
        return list(self._datasets.keys())

    def __bool__(self):
        return self.match_all or bool(self._datasets)

    def filter_repo_diff(self, repo_diff):
        """Prune a RepoDiff in place to only the matching keys."""
        if self.match_all:
            return repo_diff
        for ds_path in list(repo_diff.keys()):
            if ds_path not in self:
                del repo_diff[ds_path]
                continue
            ds_filter = self[ds_path]
            if ds_filter.match_all:
                continue
            ds_diff = repo_diff[ds_path]
            for part in list(ds_diff.keys()):
                part_filter = ds_filter[part]
                dd = ds_diff[part]
                for key in list(dd.keys()):
                    if key not in part_filter:
                        del dd[key]
                if not dd:
                    del ds_diff[part]
            if not ds_diff:
                del repo_diff[ds_path]
        return repo_diff
