"""Git's object model: blob / tree / commit / tag, in git's exact wire
format (sha1 of ``b"<type> <len>\\0" + content``, canonical tree order).

Counterpart of kart_tpu's ``core/objects.py``.
"""

import hashlib
import re
import time
from dataclasses import dataclass
from typing import NamedTuple

MODE_BLOB = 0o100644
MODE_TREE = 0o040000

EMPTY_TREE_OID = "4b825dc642cb6eb9a060e54bf8d69288fbee4904"


class ObjectFormatError(ValueError):
    pass


def hash_object(obj_type: str, data: bytes) -> str:
    """-> 40-hex sha1 oid, exactly as git computes it."""
    h = hashlib.sha1(b"%s %d\x00" % (obj_type.encode(), len(data)))
    h.update(data)
    return h.hexdigest()


class TreeEntry(NamedTuple):
    """One entry of a tree object (a tuple: trees hold millions of them)."""

    name: str
    mode: int
    oid: str

    @property
    def is_tree(self):
        return self.mode == MODE_TREE


#: mode field bytes <-> mode, for the modes git writes
_MODE_FIELD = {MODE_BLOB: b"100644", MODE_TREE: b"40000", 0o100755: b"100755",
               0o120000: b"120000", 0o160000: b"160000"}
_FIELD_MODE = {v: k for k, v in _MODE_FIELD.items()}


def tree_record(name, mode, oid) -> bytes:
    """One tree entry's bytes: ``<mode> <name>\\0<20-byte sha>``."""
    field = _MODE_FIELD.get(mode) or b"%o" % mode
    return b"%s %s\x00%s" % (field, name.encode("utf8"), bytes.fromhex(oid))


def tree_records(data) -> dict:
    """Tree object content -> {name: (mode, entry bytes)}, each entry's bytes
    as stored (rewritten only where the mode field is not git's own)."""
    out = {}
    index, modes = data.index, _FIELD_MODE
    i, n = 0, len(data)
    while i < n:
        sp = index(b" ", i)
        nul = index(b"\x00", sp)
        end = nul + 21
        field, name = data[i:sp], data[sp + 1 : nul].decode("utf8")
        mode = modes.get(field)
        if mode is None:
            mode = int(field, 8)
            out[name] = (mode, tree_record(name, mode, data[nul + 1 : end].hex()))
        else:
            out[name] = (mode, data[i:end])
        i = end
    return out


def serialise_records(records) -> bytes:
    """{name: (mode, entry bytes)} -> canonical tree object content."""
    return b"".join(raw for _, raw in sorted(
        (name + "/" if mode == MODE_TREE else name, raw) for name, (mode, raw) in records.items()))


def parse_tree(data) -> list:
    """Tree object content -> list of TreeEntry (in stored order)."""
    entries = []
    append, index, modes = entries.append, data.index, _FIELD_MODE
    i, n = 0, len(data)
    while i < n:
        sp = index(b" ", i)
        nul = index(b"\x00", sp)
        field = data[i:sp]
        append(TreeEntry(data[sp + 1 : nul].decode("utf8"), modes.get(field) or int(field, 8),
                         data[nul + 1 : nul + 21].hex()))
        i = nul + 21
    return entries


@dataclass(frozen=True)
class Signature:
    name: str
    email: str
    time: int  # unix seconds
    offset: int  # minutes east of UTC

    @classmethod
    def now(cls, name, email, offset=0):
        return cls(name, email, int(time.time()), offset)

    def format(self):
        sign = "+" if self.offset >= 0 else "-"
        off = abs(self.offset)
        return f"{self.name} <{self.email}> {self.time} {sign}{off // 60:02d}{off % 60:02d}"

    _RE = re.compile(r"^(.*) <(.*)> (\d+) ([+-])(\d{2})(\d{2})$")

    @classmethod
    def parse(cls, text):
        m = cls._RE.match(text)
        if not m:
            raise ObjectFormatError(f"Bad signature: {text!r}")
        name, email, ts, sign, hh, mm = m.groups()
        off = int(hh) * 60 + int(mm)
        return cls(name, email, int(ts), -off if sign == "-" else off)


@dataclass(frozen=True)
class Commit:
    tree: str
    parents: tuple
    author: Signature
    committer: Signature
    message: str

    def serialise(self) -> bytes:
        lines = [f"tree {self.tree}"]
        lines += [f"parent {p}" for p in self.parents]
        lines.append(f"author {self.author.format()}")
        lines.append(f"committer {self.committer.format()}")
        return ("\n".join(lines) + "\n\n" + self.message).encode("utf8")

    @classmethod
    def parse(cls, data: bytes):
        header, _, message = data.decode("utf8").partition("\n\n")
        tree = author = committer = None
        parents = []
        for line in header.split("\n"):
            key, _, value = line.partition(" ")
            if key == "tree":
                tree = value
            elif key == "parent":
                parents.append(value)
            elif key == "author":
                author = Signature.parse(value)
            elif key == "committer":
                committer = Signature.parse(value)
        if tree is None or author is None or committer is None:
            raise ObjectFormatError("Malformed commit object")
        return cls(tree, tuple(parents), author, committer, message)

    @property
    def message_summary(self):
        return self.message.split("\n", 1)[0]


@dataclass(frozen=True)
class Tag:
    """An annotated tag object (``kart tag -m``): the object it points at,
    that object's type, the tag's name, its tagger and its message."""

    target: str
    target_type: str
    name: str
    tagger: Signature
    message: str

    def serialise(self) -> bytes:
        lines = [f"object {self.target}", f"type {self.target_type}", f"tag {self.name}"]
        if self.tagger is not None:
            lines.append(f"tagger {self.tagger.format()}")
        return ("\n".join(lines) + "\n\n" + self.message).encode("utf8")

    @classmethod
    def parse(cls, data: bytes):
        header, _, message = data.decode("utf8").partition("\n\n")
        fields = dict(line.partition(" ")[::2] for line in header.split("\n"))
        if "object" not in fields or "type" not in fields:
            raise ObjectFormatError("Malformed tag object")
        tagger = Signature.parse(fields["tagger"]) if "tagger" in fields else None
        return cls(fields["object"], fields["type"], fields.get("tag", ""), tagger, message)
