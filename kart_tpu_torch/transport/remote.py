"""clone, fetch, push and the promised-blob fetch over local remotes.

A remote is a URL that :func:`open_remote` turns into a repository: a
local path or a ``file://`` URL. Every transfer, store to store on one
machine, still goes through the kartpack stream (:mod:`.pack`), so the
bytes are those a network transport would carry. A spatially filtered clone
leaves out the feature blobs whose envelopes miss the filter, records its
remote as a promisor, and later reads of those blobs raise
``ObjectPromised``; every later fetch from that remote filters again. The
blob filter is the port's ``spatial_filter.blob_filter_for_spec`` on the
source's envelope index: one launch of kernel K3 on ``device`` (None: the
card), or, without an index, a decode of each blob.

Counterpart of kart_tpu's ``transport/remote.py`` for the local lane:
``Remote``, ``open_remote``, ``normalise_url``, ``add_remote``,
``remove_remote``, the ``shallow`` file, ``fetch``, ``parse_refspec``,
``push``, ``clone`` and ``fetch_promised_blobs``. An ``http(s)://``,
``ssh://`` or scp-like URL raises :class:`NotYetImplemented` before
anything is written: those lanes, their resumable fetch, retry policy and
telemetry are not ported.
"""

import os
import shutil
import sys
import tempfile

from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.refs import RefError, check_ref_format
from kart_tpu_torch.core.repo import KartConfigKeys, KartRepo, NotFound, NotYetImplemented
from kart_tpu_torch.transport.pack import read_pack, write_pack
from kart_tpu_torch.transport.protocol import ObjectEnumerator

SHALLOW_FILE = "shallow"


class RemoteError(ValueError):
    pass


class Remote:
    """A named remote of a repository's config (``remote.<name>.*``)."""

    def __init__(self, repo, name):
        self.repo = repo
        self.name = name

    @property
    def url(self):
        url = self.repo.config.get(f"remote.{self.name}.url")
        if url is None:
            raise RemoteError(f"No such remote: {self.name!r}")
        return url

    @property
    def is_promisor(self):
        return self.repo.config.get_bool(f"remote.{self.name}.promisor")

    @property
    def partial_clone_filter(self):
        return self.repo.config.get(f"remote.{self.name}.partialclonefilter")

    def open(self) -> KartRepo:
        return open_remote(self.url)


def is_http_url(url):
    return url.startswith("http://") or url.startswith("https://")


def is_ssh_url(url):
    """An ``ssh://[user@]host[:port]/path`` URL or an scp-like
    ``[user@]host:path`` (no '/' before the colon, not a one-letter drive).
    A host or path that begins with '-', or a port that is not digits, is
    not one: it could reach ssh as an option."""

    def checked(userhost, port, path):
        return not (userhost.startswith("-") or path.startswith("-")
                    or (port is not None and not str(port).isdigit()))

    if url.startswith("ssh://"):
        hostpart, slash, path = url[len("ssh://"):].partition("/")
        if not slash:
            return False
        user, at, host = hostpart.rpartition("@")
        port, userhost = None, hostpart
        if host.startswith("["):  # a bracketed IPv6 address, maybe with a port
            addr, bracket, tail = host.partition("]")
            if not bracket or (tail and not tail.startswith(":")):
                return False
            userhost = (user + at if at else "") + addr[1:]
            port = tail[1:] if tail else None
        elif ":" in host:
            hostonly, _, port = host.rpartition(":")
            userhost = (user + at if at else "") + hostonly
        return checked(userhost, port, "/" + path)
    if "://" in url:
        return False
    head, sep, path = url.partition(":")
    return bool(sep and "/" not in head and len(head) > 1 and path) and checked(head, None, path)


def refuse_network(url):
    """Raise NotYetImplemented for a URL of a network lane."""
    if is_http_url(url) or is_ssh_url(url):
        raise NotYetImplemented(
            f"Network remote {url!r}: the http(s) and ssh transports are not ported yet")


def open_remote(url) -> KartRepo:
    """A local remote URL (a path or ``file://``) -> its repository."""
    if url.startswith("file://"):
        url = url[len("file://"):]
    if is_http_url(url) or is_ssh_url(url):
        raise RemoteError(f"Network remote {url!r} has no local repository to open")
    if "://" in url:
        raise RemoteError(f"Unsupported remote URL scheme: {url!r} "
                          f"(local paths, file://, http(s):// and ssh:// only)")
    try:
        repo = KartRepo(url)
    except NotFound:
        raise RemoteError(f"Remote repository not found: {url!r}")
    # the URL must be the repository, not a directory inside one
    if os.path.realpath(repo.workdir or repo.gitdir) != os.path.realpath(url):
        raise RemoteError(f"Remote repository not found: {url!r}")
    return repo


def normalise_url(url):
    """A local path is stored absolute, so the remote resolves from any
    directory."""
    if url.startswith("file://") or "://" in url or is_ssh_url(url):
        return url
    return os.path.abspath(url)


def add_remote(repo, name, url):
    if repo.config.get(f"remote.{name}.url") is not None:
        raise RemoteError(f"Remote {name!r} already exists")
    repo.config.set_many({f"remote.{name}.url": normalise_url(url),
                          f"remote.{name}.fetch": f"+refs/heads/*:refs/remotes/{name}/*"})


def remove_remote(repo, name):
    if repo.config.get(f"remote.{name}.url") is None:
        raise RemoteError(f"No such remote: {name!r}")
    for key in list(repo.config.keys(f"remote.{name}.")):
        del repo.config[key]
    # the whole tracking directory, its HEAD symref included
    shutil.rmtree(os.path.join(repo.gitdir, "refs", "remotes", name), ignore_errors=True)


# -- the shallow file ---------------------------------------------------------


def read_shallow(repo):
    content = repo.read_gitdir_file(SHALLOW_FILE)
    if not content:
        return set()
    return {line.strip() for line in content.splitlines() if line.strip()}


def write_shallow(repo, oids):
    if oids:
        repo.write_gitdir_file(SHALLOW_FILE, "".join(o + "\n" for o in sorted(oids)))
    else:
        repo.remove_gitdir_file(SHALLOW_FILE)


def _update_shallow(repo, new_boundary):
    """A commit is shallow while one of its parents is absent, so a
    deepening fetch clears the commits whose parents arrived."""
    candidates = read_shallow(repo) | set(new_boundary)
    if not candidates:
        return
    still_shallow = set()
    for oid in candidates:
        try:
            parents = repo.odb.read_commit(oid).parents
        except ObjectMissing:
            continue  # the boundary commit itself is gone
        if any(not repo.odb.contains(p) for p in parents):
            still_shallow.add(oid)
    write_shallow(repo, still_shallow)


# -- the transfer -------------------------------------------------------------


def _transfer(src_odb, dst_odb, wants, *, depth=None, blob_filter=None,
              sender_shallow=frozenset()):
    """Ship what ``wants`` reach and ``dst_odb`` lacks through one kartpack
    stream into one new pack. -> the ObjectEnumerator (its counts and
    shallow boundary)."""
    # nothing is written to dst_odb before the walk ends (the stream is spooled first)
    enum = ObjectEnumerator(src_odb, wants, has=dst_odb.contains_snapshot(), depth=depth,
                            blob_filter=blob_filter, sender_shallow=sender_shallow)
    with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as wire:
        write_pack(wire, iter(enum))
        wire.seek(0)
        with dst_odb.bulk_pack():
            for obj_type, content in read_pack(wire):
                dst_odb.write_raw(obj_type, content)
    return enum


def fetch(repo, remote_name="origin", *, depth=None, filter_spec=None, device=None):
    """Fetch every branch into ``refs/remotes/<name>/*`` and the tags the
    repository lacks into ``refs/tags/*``. ``filter_spec``: a "w,s,e,n"
    rectangle (EPSG:4326) whose blob filter runs on ``device``; a promisor
    remote's own filter applies when none is given. -> {local ref: oid} of
    the refs updated."""
    remote = Remote(repo, remote_name)
    if filter_spec is None and remote.is_promisor:
        spec = remote.partial_clone_filter
        if spec and spec.startswith("extension:spatial="):
            filter_spec = spec[len("extension:spatial="):]
    refuse_network(remote.url)
    src = remote.open()
    branch_tips = {ref[len("refs/heads/"):]: oid for ref, oid in src.refs.iter_refs("refs/heads/")}
    tag_tips = {ref[len("refs/tags/"):]: oid for ref, oid in src.refs.iter_refs("refs/tags/")}
    blob_filter = None
    if filter_spec is not None:
        from kart_tpu_torch.spatial_filter import blob_filter_for_spec

        blob_filter = blob_filter_for_spec(src, filter_spec, device=device)
    enum = _transfer(src.odb, repo.odb, [*branch_tips.values(), *tag_tips.values()],
                     depth=depth, blob_filter=blob_filter, sender_shallow=read_shallow(src))
    kind, target = src.refs.head_target()
    head_branch = (target[len("refs/heads/"):]
                   if kind == "symbolic" and target.startswith("refs/heads/") else None)

    updated, skipped = {}, []
    for names, prefix, replace in ((branch_tips, f"refs/remotes/{remote_name}/", True),
                                   (tag_tips, "refs/tags/", False)):
        for name, oid in names.items():
            local_ref = prefix + name
            # names from another repository get the rules a push gets
            try:
                check_ref_format(local_ref, require_refs_prefix=True)
            except RefError:
                skipped.append(name)
                continue
            current = repo.refs.get(local_ref)
            if (current != oid) if replace else current is None:
                repo.refs.set(local_ref, oid, log_message=f"fetch {remote_name}")
                updated[local_ref] = oid
    if skipped:
        print(f"warning: ignored {len(skipped)} invalid remote ref name(s): "
              + ", ".join(repr(s) for s in skipped[:5]), file=sys.stderr)
    _update_shallow(repo, enum.shallow_boundary)
    # the remote's HEAD as a symref, so that clone knows the default branch
    if head_branch is not None:
        head_path = os.path.join(repo.gitdir, "refs", "remotes", remote_name, "HEAD")
        os.makedirs(os.path.dirname(head_path), exist_ok=True)
        with open(head_path, "w") as f:
            f.write(f"ref: refs/remotes/{remote_name}/{head_branch}\n")
    return updated


# -- push ---------------------------------------------------------------------


def parse_refspec(repo, refspec):
    """'+src:dst', 'src:dst', 'src' or ':dst' (a delete) -> (src, dst, force)."""
    force = refspec.startswith("+")
    if force:
        refspec = refspec[1:]
    src, sep, dst = refspec.partition(":")
    if not sep:
        dst = src
    return src or None, dst or src, force


def _resolve_push_source(repo, src_name):
    src_ref = src_name if src_name.startswith("refs/") else f"refs/heads/{src_name}"
    new_oid = repo.refs.get(src_ref)
    if new_oid is None:
        try:
            new_oid = repo.resolve_refish(src_name)[0]
        except NotFound:
            new_oid = None
    if new_oid is None:
        raise RemoteError(f"Unknown ref to push: {src_name!r}")
    return src_ref, new_oid


def push(repo, remote_name="origin", refspecs=(), *, force=False, set_upstream=False):
    """Push refs to the remote (default: the current branch to the branch of
    its name), refusing a non-fast-forward update without ``force``.
    -> {remote ref: oid, or None for a delete}."""
    remote = Remote(repo, remote_name)
    if not refspecs:
        branch = repo.refs.head_branch()
        if branch is None:
            raise RemoteError("Cannot push: HEAD is detached and no refspec given")
        refspecs = [f"{branch}:{branch}"]
    refuse_network(remote.url)
    dst = remote.open()
    updated = {}
    for spec in refspecs:
        src_name, dst_name, spec_force = parse_refspec(repo, spec)
        spec_force = spec_force or force
        dst_ref = dst_name if dst_name.startswith("refs/") else f"refs/heads/{dst_name}"
        if src_name is None:
            if dst.refs.get(dst_ref) is None:
                raise RemoteError(f"Remote ref does not exist: {dst_ref}")
            dst.refs.delete(dst_ref)
            updated[dst_ref] = None
            continue
        src_ref, new_oid = _resolve_push_source(repo, src_name)
        old_oid = dst.refs.get(dst_ref)
        if old_oid and not spec_force and (
                not repo.odb.contains(old_oid) or not repo.is_ancestor(old_oid, new_oid)):
            raise RemoteError(f"Push to {dst_ref} rejected (non-fast-forward); "
                              "fetch first or use --force")
        enum = _transfer(repo.odb, dst.odb, [new_oid], sender_shallow=read_shallow(repo))
        # a push from a shallow clone truncates the remote's history: say so there
        _update_shallow(dst, enum.shallow_boundary)
        dst.refs.set(dst_ref, new_oid, log_message=f"push from {repo.gitdir}")
        updated[dst_ref] = new_oid
        if dst_ref.startswith("refs/heads/"):
            repo.refs.set(f"refs/remotes/{remote_name}/{dst_ref[len('refs/heads/'):]}",
                          new_oid, log_message="update by push")
            if set_upstream and src_ref.startswith("refs/heads/"):
                b = src_ref[len("refs/heads/"):]
                repo.config.set_many({f"branch.{b}.remote": remote_name,
                                      f"branch.{b}.merge": dst_ref})
    return updated


# -- clone --------------------------------------------------------------------


def clone(url, directory, *, bare=False, depth=None, spatial_filter_spec=None, wc_location=None,
          do_checkout=True, branch=None, device=None):
    """Clone a repository into ``directory``. ``spatial_filter_spec`` (a
    ``ResolvedSpatialFilterSpec`` or None) makes a filtered partial clone:
    the feature blobs outside it stay on the remote, which becomes a
    promisor; ``device`` is where the blob filter runs. A failed clone
    removes the repository it began. -> the new KartRepo."""
    refuse_network(url)
    directory = os.path.abspath(directory)
    repo = KartRepo.init_repository(directory, bare=bare)
    try:
        add_remote(repo, "origin", url)
        filter_spec = None
        if spatial_filter_spec is not None:
            filter_spec = spatial_filter_spec.filter_arg
            repo.config.set_many({
                "remote.origin.promisor": "true",
                "remote.origin.partialclonefilter": "extension:spatial=" + filter_spec,
                **spatial_filter_spec.config_items(),
            })
        fetch(repo, "origin", depth=depth, filter_spec=filter_spec, device=device)
        # the branch to check out: the one asked for, the remote's HEAD, or the first
        if branch is None:
            head_file = os.path.join(repo.gitdir, "refs", "remotes", "origin", "HEAD")
            if os.path.exists(head_file):
                with open(head_file) as f:
                    target = f.read().strip()
                prefix = "ref: refs/remotes/origin/"
                if target.startswith(prefix):
                    branch = target[len(prefix):]
        if branch is None:
            heads = [r for r, _ in repo.refs.iter_refs("refs/remotes/origin/")]
            branch = heads[0].split("/")[-1] if heads else "main"
        tip = repo.refs.get(f"refs/remotes/origin/{branch}")
        if tip is not None:
            repo.refs.set(f"refs/heads/{branch}", tip, log_message="clone")
            repo.config.set_many({f"branch.{branch}.remote": "origin",
                                  f"branch.{branch}.merge": f"refs/heads/{branch}"})
        repo.refs.set_head(f"refs/heads/{branch}", log_message="clone")
        if not bare and tip is not None and do_checkout:
            from kart_tpu_torch.workingcopy import default_location, get_working_copy

            repo.config.set_many({KartConfigKeys.KART_WORKINGCOPY_LOCATION:
                                  wc_location or default_location(repo)})
            wc = get_working_copy(repo, allow_uncreated=True, device=device)
            if wc is not None:
                wc.create_and_initialise()
                structure = repo.structure("HEAD")
                wc.write_full(structure, *structure.datasets)
        return repo
    except BaseException:
        shutil.rmtree(repo.gitdir, ignore_errors=True)
        raise


# -- the promised-blob fetch --------------------------------------------------


def fetch_promised_blobs(repo, oids):
    """Fetch the blobs ``oids`` the repository lacks from its promisor
    remote in one kartpack stream. -> the number fetched."""
    oids = [o for o in oids if not repo.odb.contains(o)]
    if not oids:
        return 0
    promisor = next((Remote(repo, name) for name in repo.remotes()
                     if repo.config.get_bool(f"remote.{name}.promisor")), None)
    if promisor is None:
        raise RemoteError("No promisor remote configured")
    refuse_network(promisor.url)
    src = promisor.open()

    def pull():
        for oid in oids:
            try:
                yield src.odb.read_raw(oid)
            except ObjectMissing:
                raise RemoteError(f"Promisor remote {promisor.name!r} is missing promised "
                                  f"object {oid}")

    fetched = 0
    with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as wire:
        write_pack(wire, pull())
        wire.seek(0)
        with repo.odb.bulk_pack():
            for obj_type, content in read_pack(wire):
                repo.odb.write_raw(obj_type, content)
                fetched += 1
    return fetched
