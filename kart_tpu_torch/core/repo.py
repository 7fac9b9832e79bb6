"""The repository: a directory with a ``.kart`` gitdir (``.sno`` and bare
gitdirs are recognised too) holding objects, refs and config.

Counterpart of kart_tpu's ``core/repo.py``: ``KartRepo`` with ``_locate``,
``init_repository``, ``resolve_refish``, ``resolve_commit``,
``walk_commits``, ``merge_base``, ``structure``, ``create_commit``, the
``head_*`` properties, ``remotes``, ``remote_url``, ``has_promisor_remote``,
``create_tag``, ``del_config``, the spatial filter's config keys
(``KartConfigKeys``) and the merge state machine (``KartRepoState``, the
``MERGE_*`` state files in the gitdir), ``is_bare``, ``is_ancestor`` and
the ``working_copy`` property (:mod:`kart_tpu_torch.workingcopy`), and
the store's upkeep: ``gc`` (loose objects packed through the pack writer,
``--auto``, ``--grace=N``, ``KART_GC_GRACE``, ``--prune-now``) and
``find_stale_leftovers`` (the debris a crashed writer leaves, which ``gc``
sweeps and ``fsck`` reports).
"""

import hashlib
import heapq
import os
import re
import shutil
import struct
import time

from kart_tpu_torch.core.objects import Commit, Signature, Tag
from kart_tpu_torch.core.odb import ObjectDb, ObjectMissing
from kart_tpu_torch.core.refs import Config, RefStore

DEFAULT_BRANCH = "main"
DEFAULT_REPO_VERSION = 3

_EMPTY = "[EMPTY]"


class RepoError(ValueError):
    pass


class NotFound(RepoError):
    pass


class InvalidOperation(RepoError):
    pass


class NotYetImplemented(RepoError):
    """A repository feature this port does not handle yet."""


class KartRepoState:
    """NORMAL, or MERGING while a ``MERGE_HEAD`` file exists."""

    NORMAL = "normal"
    MERGING = "merging"

    @classmethod
    def bad_state_message(cls, state, allowed_states):
        if state == cls.MERGING:
            return (
                'A merge is ongoing - see "kart merge --continue" / '
                '"kart merge --abort" / "kart conflicts" / "kart resolve"'
            )
        return f"Repo state {state} does not allow this command"


class KartConfigKeys:
    """The kart.* config keys the port reads."""

    KART_REPOSTRUCTURE_VERSION = "kart.repostructure.version"
    KART_WORKINGCOPY_LOCATION = "kart.workingcopy.location"
    KART_SPATIALFILTER_GEOMETRY = "kart.spatialfilter.geometry"
    KART_SPATIALFILTER_CRS = "kart.spatialfilter.crs"


# state files of an ongoing merge, directly in the gitdir
MERGE_HEAD = "MERGE_HEAD"
MERGE_INDEX = "MERGE_INDEX"
MERGE_BRANCH = "MERGE_BRANCH"
MERGE_MSG = "MERGE_MSG"


class KartRepo:
    """Open an existing repository with ``KartRepo(path)``; create one with
    :meth:`init_repository`."""

    def __init__(self, path):
        path = os.path.abspath(path)
        self.gitdir, self.workdir = self._locate(path)
        if self.gitdir is None:
            raise NotFound(f"Not an existing kart repository: {path!r}")
        self.refs = RefStore(self.gitdir)
        self.config = Config(os.path.join(self.gitdir, "config"))
        self.odb = ObjectDb(os.path.join(self.gitdir, "objects"),
                            promisor_check=self.has_promisor_remote)

    @staticmethod
    def _locate(path):
        """-> (gitdir, workdir-or-None), searching path and its parents."""
        probe = path
        while True:
            for dot in (".kart", ".sno"):
                gitdir = os.path.join(probe, dot)
                if os.path.isdir(os.path.join(gitdir, "objects")):
                    return gitdir, probe
            if os.path.isdir(os.path.join(probe, "objects")) and os.path.exists(
                os.path.join(probe, "HEAD")
            ):
                return probe, None
            parent = os.path.dirname(probe)
            if parent == probe:
                return None, None
            probe = parent

    @classmethod
    def init_repository(cls, path, *, bare=False, initial_branch=DEFAULT_BRANCH):
        path = os.path.abspath(path)
        gitdir = path if bare else os.path.join(path, ".kart")
        if os.path.isdir(os.path.join(gitdir, "objects")):
            raise InvalidOperation(f"Repository already exists at {path!r}")
        os.makedirs(os.path.join(gitdir, "objects", "info"), exist_ok=True)
        os.makedirs(os.path.join(gitdir, "refs", "heads"), exist_ok=True)
        with open(os.path.join(gitdir, "HEAD"), "w") as f:
            f.write(f"ref: refs/heads/{initial_branch}\n")
        Config(os.path.join(gitdir, "config")).set_many({
            "core.repositoryformatversion": "0",
            "core.bare": bare,
            KartConfigKeys.KART_REPOSTRUCTURE_VERSION: str(DEFAULT_REPO_VERSION),
        })
        if not bare:
            # a git index with a required "kart" extension: stock git
            # refuses to touch the worktree
            body = b"DIRC" + struct.pack(">II", 2, 0)
            ext = b"kart_tpu locked index"
            body += b"kart" + struct.pack(">I", len(ext)) + ext
            with open(os.path.join(gitdir, "index"), "wb") as f:
                f.write(body + hashlib.sha1(body).digest())
        return cls(path)

    @property
    def is_bare(self):
        return self.workdir is None

    @property
    def head_branch(self):
        return self.refs.head_branch()

    @property
    def head_commit_oid(self):
        return self.refs.head_resolved()

    @property
    def head_is_unborn(self):
        return self.head_commit_oid is None

    @property
    def head_tree_oid(self):
        oid = self.head_commit_oid
        return self.odb.read_commit(oid).tree if oid else None

    @property
    def version(self):
        for key in (KartConfigKeys.KART_REPOSTRUCTURE_VERSION, "sno.repository.version"):
            value = self.config.get_int(key)
            if value is not None:
                return value
        return DEFAULT_REPO_VERSION

    @property
    def state(self):
        if os.path.exists(os.path.join(self.gitdir, MERGE_HEAD)):
            return KartRepoState.MERGING
        return KartRepoState.NORMAL

    def gitdir_file(self, name):
        return os.path.join(self.gitdir, name)

    def read_gitdir_file(self, name):
        """The stripped text of a state file, or None when it is absent."""
        path = self.gitdir_file(name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().strip()

    def write_gitdir_file(self, name, content):
        with open(self.gitdir_file(name), "w") as f:
            f.write(content if content.endswith("\n") else content + "\n")

    def remove_gitdir_file(self, name):
        path = self.gitdir_file(name)
        if os.path.exists(path):
            os.remove(path)

    @property
    def working_copy(self):
        """The repository's initialised working copy, or None; a non-force
        reset of it classifies on the card (``get_working_copy(repo,
        device=...)`` names another device)."""
        from kart_tpu_torch.workingcopy import get_working_copy

        return get_working_copy(self)

    def remotes(self):
        """The names of the configured remotes, sorted."""
        return sorted({".".join(k.split(".")[1:-1]) for k in self.config.keys("remote.")
                       if len(k.split(".")) >= 3})

    def remote_url(self, name):
        return self.config.get(f"remote.{name}.url")

    def has_promisor_remote(self):
        return any(self.config.get_bool(k) for k in self.config.keys("remote.")
                   if k.endswith(".promisor") and k.count(".") >= 2)

    def del_config(self, key):
        del self.config[key]

    def spatial_filter_spec(self):
        """The repo's spatial filter (set by a filtered clone) as a
        :class:`~kart_tpu_torch.spatial_filter.ResolvedSpatialFilterSpec`,
        or None when the filter matches everything."""
        from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec

        spec = ResolvedSpatialFilterSpec.from_repo_config(self)
        return None if spec.match_all else spec

    def signature(self, role="committer"):
        prefix = "GIT_AUTHOR" if role == "author" else "GIT_COMMITTER"
        name = os.environ.get(f"{prefix}_NAME") or self.config.get("user.name") or "Kart TPU"
        email = (os.environ.get(f"{prefix}_EMAIL") or self.config.get("user.email")
                 or "kart_tpu@localhost")
        date = os.environ.get(f"{prefix}_DATE")
        if date:
            m = re.fullmatch(r"(\d+) ([+-])(\d{2})(\d{2})", date.strip())
            if m:
                ts, sign, hh, mm = m.groups()
                off = int(hh) * 60 + int(mm)
                return Signature(name, email, int(ts), -off if sign == "-" else off)
        return Signature.now(name, email)

    # -- refish resolution ---------------------------------------------------

    def resolve_refish(self, refish):
        """HEAD, branch, tag, full/short oid, with ^/~n suffixes, and
        '[EMPTY]' -> (oid_or_None, ref_name_or_None)."""
        if refish in (_EMPTY, None):
            return None, None
        base, ops = _split_rev_operators(refish)
        oid, ref = self._resolve_plain(base)
        for op, count in ops:
            if oid is None:
                raise NotFound(f"Cannot apply {op} to empty revision")
            commit = self.odb.read_commit(oid)
            if op == "~":
                for _ in range(count):
                    if not commit.parents:
                        raise NotFound(f"Revision {refish!r} walks past the root commit")
                    oid = commit.parents[0]
                    commit = self.odb.read_commit(oid)
            elif op == "^?":  # first parent, or the empty revision
                oid = commit.parents[0] if commit.parents else None
            else:
                if count == 0:
                    continue
                if len(commit.parents) < count:
                    raise NotFound(f"Revision {refish!r}: no parent #{count}")
                oid = commit.parents[count - 1]
            ref = None
        return oid, ref

    def _resolve_plain(self, name):
        if name == "HEAD":
            kind, target = self.refs.head_target()
            if kind == "symbolic":
                return self.refs.get(target), target
            return target, None
        for candidate in (name, f"refs/heads/{name}", f"refs/tags/{name}",
                          f"refs/remotes/{name}"):
            oid = self.refs.get(candidate)
            if oid is not None:
                return self._peel_to_commit_oid(oid), candidate
        if re.fullmatch(r"[0-9a-f]{40}", name) and self.odb.contains(name):
            return name, None
        if re.fullmatch(r"[0-9a-f]{4,39}", name):
            matches = self.odb.find_oids_with_prefix(name)
            if len(matches) == 1:
                return self._peel_to_commit_oid(matches[0]), None
            if len(matches) > 1:
                raise NotFound(f"Ambiguous short id {name!r}")
        raise NotFound(f"No such commit, branch or tag: {name!r}")

    def _peel_to_commit_oid(self, oid):
        obj_type, content = self.odb.read_raw(oid)
        while obj_type == "tag":
            oid = Tag.parse(content).target
            obj_type, content = self.odb.read_raw(oid)
        return oid

    def resolve_commit(self, refish) -> Commit:
        oid, _ = self.resolve_refish(refish)
        if oid is None:
            raise NotFound(f"{refish!r} resolves to the empty revision")
        return self.odb.read_commit(oid)

    # -- history -------------------------------------------------------------

    def walk_commits(self, start_oid, *, first_parent=False):
        """Yield (oid, Commit) from ``start_oid`` backwards, newest
        committer time first (``git log``'s default order); equal times go
        in the order the commits were reached, children first. A missing
        parent is a shallow boundary; a missing ``start_oid`` raises
        ObjectMissing."""
        seen, heap = set(), []
        counter = 0

        def push(oid, *, tolerate_missing):
            nonlocal counter
            if oid in seen:
                return
            seen.add(oid)
            try:
                commit = self.odb.read_commit(oid)
            except ObjectMissing:
                if tolerate_missing:
                    return
                raise
            heapq.heappush(heap, (-commit.committer.time, counter, oid, commit))
            counter += 1

        push(start_oid, tolerate_missing=False)
        while heap:
            _, _, oid, commit = heapq.heappop(heap)
            yield oid, commit
            for p in commit.parents[:1] if first_parent else commit.parents:
                push(p, tolerate_missing=True)

    def merge_base(self, oid_a, oid_b):
        """Best common ancestor: the newest (by committer time) ancestor of
        ``oid_b`` that is reachable from ``oid_a``, or None."""
        ancestors_a = self._ancestor_set(oid_a)
        if oid_b in ancestors_a:
            return oid_b
        seen, heap = set(), []

        def push(oid):
            if oid not in seen:
                seen.add(oid)
                try:
                    commit = self.odb.read_commit(oid)
                except ObjectMissing:
                    return  # shallow-clone boundary
                heapq.heappush(heap, (-commit.committer.time, oid, commit))

        push(oid_b)
        while heap:
            _, oid, commit = heapq.heappop(heap)
            if oid in ancestors_a:
                return oid
            for p in commit.parents:
                push(p)
        return None

    def topo_commits(self, start_oids):
        """Every commit reachable from ``start_oids``, parents before
        children."""
        order, visited = [], set()
        stack = [(oid, False) for oid in start_oids]
        while stack:
            oid, processed = stack.pop()
            if processed:
                order.append(oid)
                continue
            if oid in visited:
                continue
            try:
                parents = self.odb.read_commit(oid).parents
            except ObjectMissing:
                continue  # shallow-clone boundary
            visited.add(oid)
            stack.append((oid, True))
            stack.extend((p, False) for p in parents)
        return order

    def is_ancestor(self, maybe_ancestor, descendant):
        return maybe_ancestor in self._ancestor_set(descendant)

    def _ancestor_set(self, oid):
        out, stack = set(), [oid]
        while stack:
            o = stack.pop()
            if o in out:
                continue
            try:
                parents = self.odb.read_commit(o).parents
            except ObjectMissing:
                continue  # shallow-clone boundary
            out.add(o)
            stack.extend(parents)
        return out

    # -- writing -------------------------------------------------------------

    def create_commit(self, ref, tree_oid, message, parents, *, author=None,
                      committer=None):
        """-> new commit oid; updates ``ref`` (HEAD: its branch, or HEAD
        itself when detached)."""
        commit = Commit(
            tree=tree_oid,
            parents=tuple(parents),
            author=author or self.signature("author"),
            committer=committer or self.signature("committer"),
            message=message if message.endswith("\n") else message + "\n",
        )
        oid = self.odb.write_commit(commit)
        log = f"commit: {commit.message_summary}"
        if ref == "HEAD":
            branch = self.refs.head_branch()
            if branch:
                self.refs.set(branch, oid, log_message=log)
            else:
                self.refs.set_head(oid, log_message=log)
        elif ref is not None:
            self.refs.set(ref, oid, log_message=log)
        return oid

    def create_tag(self, name, target_oid, message=None, tagger=None):
        """``refs/tags/<name>`` at ``target_oid``; with ``message``, through
        a new annotated tag object. -> the oid the ref holds."""
        ref = f"refs/tags/{name}"
        if self.refs.exists(ref):
            raise InvalidOperation(f"Tag already exists: {name}")
        if not message:
            self.refs.set(ref, target_oid)
            return target_oid
        tag = Tag(target=target_oid, target_type=self.odb.object_type(target_oid), name=name,
                  tagger=tagger or self.signature(),
                  message=message if message.endswith("\n") else message + "\n")
        oid = self.odb.write_raw("tag", tag.serialise())
        self.refs.set(ref, oid)
        return oid

    def structure(self, refish="HEAD"):
        from kart_tpu_torch.core.structure import RepoStructure

        return RepoStructure(self, refish)

    def datasets(self, refish="HEAD"):
        return self.structure(refish).datasets

    #: git's default gc.auto threshold: ``gc --auto`` packs nothing below
    #: this many loose objects
    GC_AUTO_LOOSE_THRESHOLD = 6700

    #: leftovers younger than this survive a sweep: a ``.tmp-pack-*`` that
    #: an import is writing now looks like a dead one except by its age
    STALE_GRACE_SECONDS = 3600.0

    #: the temporary names of this store's atomic writes: loose objects'
    #: and idx files' ``<name>.tmp<pid>``, refs' and config's
    #: ``<name>.lock<pid>``, the pack writer's ``.tmp-pack-*``
    _STALE_FILE_RE = re.compile(r"(\.(tmp|lock)\d*$)|(^\.tmp-)")

    def find_stale_leftovers(self, grace_seconds=None):
        """The debris a dead process left, older than the grace period:
        ``*.tmp<pid>`` and ``.tmp-pack-*`` files under ``objects/``,
        ``*.lock<pid>`` under ``refs/`` and in the gitdir, and abandoned
        push quarantines (``objects/quarantine/*``). Yields absolute
        paths."""
        if grace_seconds is None:
            grace_seconds = self.STALE_GRACE_SECONDS
        cutoff = time.time() - grace_seconds

        def old_enough(path):
            try:
                return os.lstat(path).st_mtime <= cutoff
            except OSError:
                return False

        def newest_mtime(root):
            """A quarantine lives while anything streaming into it does."""
            newest = 0.0
            for dirpath, _, filenames in os.walk(root):
                for name in [os.curdir, *filenames]:
                    try:
                        newest = max(newest, os.lstat(os.path.join(dirpath, name)).st_mtime)
                    except OSError:
                        pass
            return newest

        objects_dir = os.path.join(self.gitdir, "objects")
        quarantine_dir = os.path.join(objects_dir, "quarantine")
        if os.path.isdir(quarantine_dir):
            for name in sorted(os.listdir(quarantine_dir)):
                p = os.path.join(quarantine_dir, name)
                if os.path.isdir(p) and newest_mtime(p) <= cutoff:
                    yield p
        for root in (objects_dir, os.path.join(self.gitdir, "refs")):
            for dirpath, _, filenames in os.walk(root):
                if dirpath.startswith(quarantine_dir):
                    continue
                for fn in sorted(filenames):
                    if self._STALE_FILE_RE.search(fn):
                        p = os.path.join(dirpath, fn)
                        if old_enough(p):
                            yield p
        for fn in sorted(os.listdir(self.gitdir)):
            p = os.path.join(self.gitdir, fn)
            if os.path.isfile(p) and self._STALE_FILE_RE.search(fn) and old_enough(p):
                yield p

    def gc(self, *args, grace_seconds=None):
        """Sweep crash leftovers, then pack the loose objects into one pack
        and remove them. ``--auto`` packs only above
        :data:`GC_AUTO_LOOSE_THRESHOLD` loose objects; ``--grace=N`` (or
        ``KART_GC_GRACE``, seconds) is the age a leftover must reach to be
        swept, ``--prune-now`` sweeps whatever its age.
        -> {"packed": n, "pruned": n}."""
        objects_dir = os.path.join(self.gitdir, "objects")
        auto = "--auto" in args
        if grace_seconds is None:
            for a in args:
                if isinstance(a, str) and a.startswith("--grace="):
                    try:
                        grace_seconds = float(a[len("--grace="):])
                    except ValueError:
                        pass
            if "--prune-now" in args:
                grace_seconds = 0.0
        if grace_seconds is None:
            env = os.environ.get("KART_GC_GRACE")
            if env is not None:
                try:
                    grace_seconds = float(env)
                except ValueError:
                    pass
        pruned = 0
        for path in list(self.find_stale_leftovers(grace_seconds)):
            try:
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.remove(path)
                pruned += 1
            except OSError:
                pass

        loose = []
        for prefix in sorted(os.listdir(objects_dir)):
            if len(prefix) != 2:
                continue
            d = os.path.join(objects_dir, prefix)
            for name in sorted(os.listdir(d)):
                if len(name) == 38 and not name.endswith(".tmp"):
                    loose.append((prefix + name, os.path.join(d, name)))
        if not loose or (auto and len(loose) < self.GC_AUTO_LOOSE_THRESHOLD):
            return {"packed": 0, "pruned": pruned}

        from kart_tpu_torch.core.packs import Packfile, PackWriter

        with PackWriter(os.path.join(objects_dir, "pack")) as w:
            for oid, _ in loose:
                w.add(*self.odb.read_raw(oid))
        # the new pack is visible, and serves every object, before a loose
        # copy goes
        self.odb.packs.refresh()
        pack = Packfile(w.pack_path, w.idx_path)
        try:
            for oid, _ in loose:
                if pack.read(bytes.fromhex(oid)) is None:
                    raise RuntimeError(f"gc: object {oid} missing from the new pack")
            for _, path in loose:
                try:
                    os.remove(path)
                except OSError:
                    pass
        finally:
            pack.close()
        for prefix in os.listdir(objects_dir):
            if len(prefix) == 2:
                try:
                    os.rmdir(os.path.join(objects_dir, prefix))  # the emptied fan-out dirs
                except OSError:
                    pass
        return {"packed": len(loose), "pruned": pruned}


def _split_rev_operators(refish):
    """'main~2^1' -> ('main', [('~', 2), ('^', 1)]); also '^?'."""
    m = re.match(r"^(.*?)((?:[~^]\??\d*)*)$", refish)
    ops = []
    for op, arg in re.findall(r"([~^])(\?|\d*)", m.group(2)):
        ops.append(("^?", 0) if arg == "?" else (op, int(arg) if arg else 1))
    return m.group(1), ops
