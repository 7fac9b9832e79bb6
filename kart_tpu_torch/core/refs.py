"""Refs, HEAD and the git-style config file, stored exactly as git stores
them (``refs/heads/<name>`` files of 40-hex + newline, ``packed-refs``,
a ``HEAD`` symref, an INI-with-subsections ``config``).

Counterpart of kart_tpu's ``core/refs.py``: ``RefStore`` (loose and packed
refs, their listing, existence and deletion, HEAD, symbolic refs, writes
with their reflog line, reflog reads, the directory/file conflict check
``df_conflict``) and ``Config`` (read, ``set_many``, key deletion).
"""

import os
import re
import time


class RefError(ValueError):
    pass


_BAD_REF_CHARS = re.compile(r"[\x00-\x20\x7f~^:?*\[\\]")
_DEBRIS_SHAPED = re.compile(r"\.(tmp|lock)\d*$")


def check_ref_format(ref, *, require_refs_prefix=False):
    """git's check_refname_format rules (the subset that matters for
    filesystem safety). With ``require_refs_prefix`` only ``refs/...``
    names pass (a fetch's names come from another repository). Raises
    RefError."""
    if require_refs_prefix and not ref.startswith("refs/"):
        raise RefError(f"ref name must be under refs/: {ref!r}")
    if not ref or ref.startswith("/") or ref.endswith("/") or "//" in ref:
        raise RefError(f"bad ref name: {ref!r}")
    if "@{" in ref or ".." in ref or _BAD_REF_CHARS.search(ref):
        raise RefError(f"bad ref name: {ref!r}")
    for component in ref.split("/"):
        if (not component or component.startswith(".") or component.endswith(".")
                or component.endswith(".lock") or _DEBRIS_SHAPED.search(component)):
            raise RefError(f"bad ref name: {ref!r}")
    return ref


class RefStore:
    def __init__(self, gitdir):
        self.gitdir = gitdir
        self._packed_cache = None  # (mtime, {ref: oid})

    def _ref_path(self, ref):
        if ref.startswith("/") or ".." in ref:
            raise RefError(f"unsafe ref name: {ref!r}")
        return os.path.join(self.gitdir, *ref.split("/"))

    def _packed_refs(self):
        """{ref: oid} from ``packed-refs``; '^' peel lines are skipped."""
        path = os.path.join(self.gitdir, "packed-refs")
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return {}
        if self._packed_cache and self._packed_cache[0] == mtime:
            return self._packed_cache[1]
        refs = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", "^")):
                    continue
                oid, _, ref = line.partition(" ")
                if ref:
                    refs[ref] = oid
        self._packed_cache = (mtime, refs)
        return refs

    def get(self, ref):
        """ref name -> oid, or None; loose refs win over packed ones, and a
        symref file is followed."""
        path = self._ref_path(ref)
        if not os.path.isfile(path):
            return self._packed_refs().get(ref)
        with open(path) as f:
            value = f.read().strip()
        if value.startswith("ref: "):
            return self.get(value[5:])
        return value or None

    def exists(self, ref):
        return os.path.exists(self._ref_path(ref)) or ref in self._packed_refs()

    def df_conflict(self, ref):
        """The existing ref that ``ref`` collides with at a directory/file
        boundary (``refs/heads/a`` against ``refs/heads/a/b``), or None:
        the loose store cannot hold a file and a directory of one name."""
        parts = ref.split("/")
        packed = self._packed_refs()
        for i in range(2, len(parts)):
            prefix = "/".join(parts[:i])
            if os.path.isfile(self._ref_path(prefix)) or prefix in packed:
                return prefix
        for nested, _ in self.iter_refs(ref + "/"):
            return nested
        return None

    def delete(self, ref):
        """Remove a ref, loose and packed ('^' peel lines stay with the tag
        before them)."""
        path = self._ref_path(ref)
        if os.path.exists(path):
            os.remove(path)
        if ref not in self._packed_refs():
            return
        packed_path = os.path.join(self.gitdir, "packed-refs")
        with open(packed_path) as f:
            lines = f.readlines()
        out, skipping = [], False
        for line in lines:
            stripped = line.strip()
            if stripped.startswith("^"):
                if not skipping:
                    out.append(line)
                continue
            skipping = False
            if stripped and not stripped.startswith("#") and stripped.partition(" ")[2] == ref:
                skipping = True
                continue
            out.append(line)
        tmp = packed_path + f".lock{os.getpid()}"
        with open(tmp, "w") as f:
            f.writelines(out)
        os.replace(tmp, packed_path)
        self._packed_cache = None

    def set(self, ref, oid, log_message=None):
        check_ref_format(ref)
        old = self.get(ref)
        path = self._ref_path(ref)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".lock{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(oid + "\n")
        os.replace(tmp, path)
        if log_message is not None:
            self._append_reflog(ref, old, oid, log_message)
            kind, target = self.head_target()
            if kind == "symbolic" and target == ref:
                self._append_reflog("HEAD", old, oid, log_message)

    def iter_refs(self, prefix="refs/"):
        """Yield (ref_name, oid) under ``prefix``, sorted; loose refs shadow
        packed ones of the same name, and write debris is skipped."""
        combined = {ref: oid for ref, oid in self._packed_refs().items()
                    if ref.startswith(prefix)}
        base = self._ref_path(prefix.rstrip("/"))
        if os.path.isdir(base):
            for dirpath, dirnames, filenames in sorted(os.walk(base)):
                dirnames.sort()
                for fn in sorted(filenames):
                    if re.search(r"\.(lock|tmp)\d*$", fn):
                        continue
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, self.gitdir).replace(os.sep, "/")
                    with open(full) as f:
                        value = f.read().strip()
                    if value and not value.startswith("ref: "):
                        combined[rel] = value
        yield from sorted(combined.items())

    def head_target(self):
        """-> ('symbolic', refname) or ('direct', oid) or (None, None)."""
        path = os.path.join(self.gitdir, "HEAD")
        if not os.path.exists(path):
            return None, None
        with open(path) as f:
            value = f.read().strip()
        if value.startswith("ref: "):
            return "symbolic", value[5:]
        return ("direct", value) if value else (None, None)

    def set_head(self, target, log_message=None):
        """target: 'refs/heads/x' (symbolic) or a 40-hex oid (detached)."""
        old = self.head_resolved()
        with open(os.path.join(self.gitdir, "HEAD"), "w") as f:
            if re.fullmatch(r"[0-9a-f]{40}", target):
                f.write(target + "\n")
            else:
                f.write(f"ref: {target}\n")
        if log_message is not None:
            self._append_reflog("HEAD", old, self.head_resolved(), log_message)

    def head_resolved(self):
        """-> oid HEAD points at (through one symref level), or None."""
        kind, target = self.head_target()
        return self.get(target) if kind == "symbolic" else target

    def head_branch(self):
        kind, target = self.head_target()
        return target if kind == "symbolic" else None

    def _append_reflog(self, ref, old_oid, new_oid, message):
        log_path = os.path.join(self.gitdir, "logs", *ref.split("/"))
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        zero = "0" * 40
        with open(log_path, "a") as f:
            f.write(
                f"{old_oid or zero} {new_oid or zero} "
                f"kart_tpu <kart_tpu@localhost> {int(time.time())} +0000\t{message}\n"
            )

    def read_reflog(self, ref):
        """-> [{"old", "new", "message"}] of ``ref``'s reflog, oldest first."""
        log_path = os.path.join(self.gitdir, "logs", *ref.split("/"))
        if not os.path.exists(log_path):
            return []
        entries = []
        with open(log_path) as f:
            for line in f:
                head, _, message = line.rstrip("\n").partition("\t")
                parts = head.split(" ")
                entries.append({"old": parts[0], "new": parts[1], "message": message})
        return entries


class Config:
    """Flat key-value view of a git-style config file (``core.bare``,
    ``remote.origin.url``, ...). Every key maps to a list of values; ``get``
    returns the last (git's rule)."""

    _SECTION_RE = re.compile(r'\[([A-Za-z0-9.-]+)(?:\s+"((?:[^"\\]|\\.)*)")?\]')

    def __init__(self, path):
        self.path = path
        self._values = {}
        if not os.path.exists(path):
            return
        section = ""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", ";")):
                    continue
                m = self._SECTION_RE.fullmatch(line)
                if m:
                    name, sub = m.groups()
                    section = f"{name}.{sub}" if sub is not None else name
                    continue
                key, _, value = line.partition("=")
                key = key.strip().lower()
                value = value.strip()
                if len(value) >= 2 and value[0] == '"' and value[-1] == '"':
                    value = value[1:-1].replace('\\"', '"').replace("\\\\", "\\")
                self._values.setdefault(f"{section}.{key}" if section else key, []).append(value)

    def _save(self):
        sections = {}
        for full_key, values in self._values.items():
            parts = full_key.split(".")
            if len(parts) == 2:
                header, key = f"[{parts[0]}]", parts[1]
            else:
                header, key = f'[{parts[0]} "{".".join(parts[1:-1])}"]', parts[-1]
            for value in values:
                sections.setdefault(header, []).append((key, value))
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + f".lock{os.getpid()}"
        with open(tmp, "w") as f:
            for header, items in sections.items():
                f.write(header + "\n")
                for key, value in items:
                    if re.search(r"[#;\s]", value) and not (
                        value.startswith('"') and value.endswith('"')
                    ):
                        value = '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'
                    f.write(f"\t{key} = {value}\n")
        os.replace(tmp, self.path)

    def get(self, key, default=None):
        values = self._values.get(key.lower())
        return values[-1] if values else default

    def get_bool(self, key, default=False):
        value = self.get(key)
        return default if value is None else value.lower() in ("1", "true", "yes", "on")

    def get_int(self, key, default=None):
        value = self.get(key)
        return int(value) if value is not None else default

    def set_many(self, mapping):
        for key, value in mapping.items():
            if isinstance(value, bool):
                value = "true" if value else "false"
            self._values[key.lower()] = [str(value)]
        self._save()

    def __delitem__(self, key):
        """Remove every value of ``key`` (absent: nothing to do)."""
        self._values.pop(key.lower(), None)
        self._save()

    def keys(self, prefix=""):
        prefix = prefix.lower()
        return [k for k in self._values if k.startswith(prefix)]
