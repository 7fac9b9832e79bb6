"""clone, fetch, push, pull and the promised-blob fetch, over local remotes
(paths and ``file://`` URLs), ``http(s)://`` servers (:mod:`.http`) and ssh
remotes (:mod:`.stdio`).

Every transfer, store to store on one machine included, goes through the
kartpack stream (:mod:`.pack`). A spatially filtered clone leaves out the
feature blobs whose envelopes miss the filter, records its remote as a
promisor, and later reads of those blobs raise ``ObjectPromised``; every
later fetch from that remote filters again. The blob filter is
``spatial_filter.blob_filter_for_spec`` on the source's envelope index: one
launch of kernel K3 on ``device`` (None: the card) for a local remote, on
the server's device for a network one. A network fetch that dies mid-stream
keeps what arrived and leaves a ``FETCH_RESUME`` marker, so the next fetch
ships only the rest; a network push is auto-rebased on the server when it
lost the race for its branch, or refused with kart_tpu's conflict report.

Counterpart of kart_tpu's ``transport/remote.py``.
"""

import os
import sys
import tempfile

from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.refs import RefError, check_ref_format
from kart_tpu_torch.core.repo import KartConfigKeys, KartRepo, NotFound
from kart_tpu_torch.transport.pack import PackFormatError, read_pack, write_pack
from kart_tpu_torch.transport.protocol import ObjectEnumerator

SHALLOW_FILE = "shallow"

#: gitdir marker for an in-flight network fetch — like git's shallow
#: machinery, its survival past process death is the signal that the local
#: store may hold a salvaged partial transfer, so the next fetch resumes
#: (excluding every object already present) instead of starting over.
FETCH_RESUME_FILE = "FETCH_RESUME"


class RemoteError(ValueError):
    pass


class Remote:
    """A named remote from repo config (remote.<name>.*)."""

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


def parse_ssh_url(url):
    """-> (userhost, port|None, path) for an ssh URL, or None.

    A userhost or path beginning with '-' is rejected: it would reach the
    spawned ssh as an option (the git CVE-2017-1000117 class — e.g.
    '-oProxyCommand=...' executing locally)."""

    def checked(userhost, port, path):
        if userhost.startswith("-") or path.startswith("-"):
            return None
        if port is not None and not str(port).isdigit():
            # the port rides ssh's argv after '-p'; digits-only keeps any
            # crafted string from reaching ssh as something else entirely
            return None
        return userhost, port, path

    if url.startswith("ssh://"):
        rest = url[len("ssh://"):]
        hostpart, slash, path = rest.partition("/")
        if not slash:
            return None
        port = None
        userhost = hostpart
        user, at, host = hostpart.rpartition("@")
        if host.startswith("["):  # bracketed IPv6: [::1] or [::1]:2222
            addr, bracket, tail = host.partition("]")
            if not bracket:
                return None
            userhost = (user + at if at else "") + addr[1:]
            if tail.startswith(":"):
                port = tail[1:]
            elif tail:
                return None
        elif ":" in host:
            hostonly, _, port = host.rpartition(":")
            userhost = (user + at if at else "") + hostonly
        return checked(userhost, port, "/" + path)
    if "://" in url:
        return None
    # scp-like [user@]host:path — no '/' before the colon, and not a
    # one-letter head (Windows drive)
    head, sep, path = url.partition(":")
    if sep and "/" not in head and len(head) > 1 and path:
        return checked(head, None, path)
    return None


def is_ssh_url(url):
    return parse_ssh_url(url) is not None


def network_remote(url, retry=None):
    """The wire client for a network URL — HttpRemote for http(s),
    StdioRemote for ssh:// / scp-like — or None for local paths. Both
    clients speak the same verb API (ls_refs / fetch_pack / fetch_blobs /
    receive_pack), so every caller is transport-agnostic. ``retry``: a
    RetryPolicy (defaults to env/config resolution inside the client)."""
    if is_http_url(url):
        from kart_tpu_torch.transport.http import HttpRemote

        return HttpRemote(url, retry=retry)
    from kart_tpu_torch.transport.stdio import StdioRemote

    if is_ssh_url(url):
        return StdioRemote(url, retry=retry)
    return None


def open_remote(url) -> KartRepo:
    """Resolve a *local* remote URL to a repository (local paths + file://).
    Network remotes don't open as repos — the fetch/push/clone verbs route
    them through their wire client instead."""
    if url.startswith("file://"):
        url = url[len("file://") :]
    if is_http_url(url) or is_ssh_url(url):
        raise RemoteError(
            f"Network remote {url!r} has no local repository to open"
        )
    if "://" in url:
        raise RemoteError(
            f"Unsupported remote URL scheme: {url!r} "
            f"(local paths, file://, http(s):// and ssh:// only)"
        )
    try:
        repo = KartRepo(url)
    except NotFound:
        raise RemoteError(f"Remote repository not found: {url!r}")
    # the URL must BE the repo, not merely live inside one — KartRepo's
    # parent-directory search must not silently resolve a bad remote path to
    # whatever repo happens to enclose it
    target = os.path.realpath(url)
    if os.path.realpath(repo.workdir or repo.gitdir) != target:
        raise RemoteError(f"Remote repository not found: {url!r}")
    return repo


def normalise_url(url):
    """Local-path URLs are stored absolute, so the remote resolves no matter
    what directory later commands run from."""
    if url.startswith("file://") or "://" in url or is_ssh_url(url):
        return url
    return os.path.abspath(url)


def add_remote(repo, name, url):
    if repo.config.get(f"remote.{name}.url") is not None:
        raise RemoteError(f"Remote {name!r} already exists")
    repo.config.set_many(
        {
            f"remote.{name}.url": normalise_url(url),
            f"remote.{name}.fetch": f"+refs/heads/*:refs/remotes/{name}/*",
        }
    )


def remove_remote(repo, name):
    import shutil

    if repo.config.get(f"remote.{name}.url") is None:
        raise RemoteError(f"No such remote: {name!r}")
    for key in list(repo.config.keys(f"remote.{name}.")):
        del repo.config[key]
    # remove the whole tracking-ref directory (iter_refs skips symref files
    # like refs/remotes/<name>/HEAD, so per-ref deletion would leave it)
    shutil.rmtree(
        os.path.join(repo.gitdir, "refs", "remotes", name), ignore_errors=True
    )


# -- shallow bookkeeping ---------------------------------------------------


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
    """Recompute the shallow file after a transfer: a commit is shallow iff
    any of its parents is still absent — so a deepening fetch un-shallows
    commits whose parents just arrived."""
    candidates = read_shallow(repo) | set(new_boundary)
    if not candidates:
        return
    still_shallow = set()
    for oid in candidates:
        try:
            parents = repo.odb.read_commit(oid).parents
        except ObjectMissing:
            continue  # the boundary commit itself is gone; drop the entry
        if any(not repo.odb.contains(p) for p in parents):
            still_shallow.add(oid)
    write_shallow(repo, still_shallow)


def _retry_policy(repo, remote_name):
    """The retry/backoff policy for this remote (env > remote.<name>.*
    config > defaults; see kart_tpu_torch.transport.retry)."""
    from kart_tpu_torch.transport.retry import RetryPolicy

    return RetryPolicy.from_config(repo.config, remote_name)


_OID_RE = None


def _write_resume_marker(repo, remote_name, salvaged):
    """Record the in-flight fetch + the oids salvaged so far (bounded) so a
    later process can resume without rescanning the store."""
    from kart_tpu_torch.transport.retry import EXCLUDE_CAP

    lines = [remote_name, *sorted(salvaged or ())[:EXCLUDE_CAP]]
    repo.write_gitdir_file(FETCH_RESUME_FILE, "\n".join(lines))


def _read_resume_exclusions(repo):
    """-> the exclusion seed for this fetch: oids recorded in a surviving
    FETCH_RESUME marker; if the marker exists but carries none (the
    process was hard-killed before it could record them), fall back to
    scanning the local store (bounded — exclusions are an optimisation,
    missing some merely re-ships a little)."""
    import itertools
    import re

    from kart_tpu_torch.transport.retry import EXCLUDE_CAP

    content = repo.read_gitdir_file(FETCH_RESUME_FILE)
    if content is None:
        return set()
    global _OID_RE
    if _OID_RE is None:
        _OID_RE = re.compile(r"^[0-9a-f]{40}$")
    oids = {
        line for line in content.splitlines()[1:] if _OID_RE.fullmatch(line)
    }
    if oids:
        return oids
    return set(itertools.islice(repo.odb.iter_oids(), EXCLUDE_CAP))


# -- the wire --------------------------------------------------------------


def _transfer(src_odb, dst_odb, wants, *, depth=None, blob_filter=None, sender_shallow=frozenset()):
    """Ship objects reachable from wants (minus what dst has) src→dst through
    a kartpack stream. Returns the ObjectEnumerator (for counts/boundary)."""
    enum = ObjectEnumerator(
        src_odb,
        wants,
        has=dst_odb.contains_snapshot(),
        depth=depth,
        blob_filter=blob_filter,
        sender_shallow=sender_shallow,
    )
    with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as wire:
        write_pack(wire, iter(enum))
        wire.seek(0)
        # received objects land in one new pack, not a loose file each (a
        # 1M-feature clone would otherwise create a million files)
        with dst_odb.bulk_pack():
            for obj_type, content in read_pack(wire):
                dst_odb.write_raw(obj_type, content)
    return enum


# -- fetch -----------------------------------------------------------------


def fetch(repo, remote_name="origin", *, depth=None, filter_spec=None, device=None):
    """Fetch all branches + tags from the remote into refs/remotes/<name>/*.
    Returns {local_ref: oid} of updated refs.

    filter_spec: 'w,s,e,n' spatial filter argument evaluated on the sending
    side (local remotes build the callable here; HTTP remotes evaluate it on
    the server, like the reference's upload-pack filter extension). A local
    remote's filter runs on ``device`` (None: the card)."""
    remote = Remote(repo, remote_name)

    if filter_spec is None and remote.is_promisor:
        # re-fetch from a promisor remote keeps filtering (reference:
        # remote.*.partialclonefilter persists after clone)
        spec = remote.partial_clone_filter
        if spec and spec.startswith("extension:spatial="):
            filter_spec = spec[len("extension:spatial=") :]

    net = network_remote(remote.url, retry=_retry_policy(repo, remote_name))
    if net is not None:
        from kart_tpu_torch.transport.http import HttpTransportError

        # A FETCH_RESUME marker surviving from an earlier process means that
        # fetch died mid-transfer and its salvage is sitting in our store:
        # seed the exclusion set so the server ships only the remainder
        # (content addressing makes the salvaged objects exactly as
        # trustworthy as a completed transfer's). The client mutates the
        # set in place, so even a failed retry chain leaves us knowing
        # everything that landed. This is the *cross-process* resume lane;
        # within one process the HTTP client's retry loop additionally
        # resumes mid-pack by byte range, sending the offset it already
        # holds (docs/SERVING.md §3).
        exclude = _read_resume_exclusions(repo)
        if exclude:
            tm.incr("transport.resume_seeded_oids", len(exclude))
        # one fetch = one trace: the verb calls below (ls-refs, fetch-pack
        # and each retry attempt inside them) inherit this scope's trace
        # id, so the whole retry ladder correlates with the server's
        # access-log/span records (docs/OBSERVABILITY.md §8) even when no
        # CLI root context exists (library use, bench workers)
        try:
            with tm.request_scope(verb="fetch", remote=remote_name):
                info = net.ls_refs()
                branch_tips = info["heads"]
                tag_tips = info["tags"]
                head_branch = info.get("head_branch")
                wants = list(branch_tips.values()) + list(tag_tips.values())
                repo.write_gitdir_file(FETCH_RESUME_FILE, remote_name)
                header = net.fetch_pack(
                    repo,
                    wants,
                    haves=[oid for _, oid in repo.refs.iter_refs("refs/")],
                    have_shallow=read_shallow(repo),
                    depth=depth,
                    filter_spec=filter_spec,
                    exclude=exclude,
                )
        except (HttpTransportError, PackFormatError, OSError) as e:
            # the marker stays — now carrying the salvaged oids, so the
            # next `kart fetch` resumes without rescanning the store
            _write_resume_marker(repo, remote_name, exclude)
            raise RemoteError(str(e))
        finally:
            net.close()
        repo.remove_gitdir_file(FETCH_RESUME_FILE)
        shallow_boundary = set(header.get("shallow_boundary", ()))
    else:
        src = remote.open()
        branch_tips = {}  # branch name -> oid
        tag_tips = {}
        for ref, oid in src.refs.iter_refs("refs/heads/"):
            branch_tips[ref[len("refs/heads/") :]] = oid
        for ref, oid in src.refs.iter_refs("refs/tags/"):
            tag_tips[ref[len("refs/tags/") :]] = oid
        wants = list(branch_tips.values()) + list(tag_tips.values())

        blob_filter = None
        if filter_spec is not None:
            from kart_tpu_torch.spatial_filter import blob_filter_for_spec

            blob_filter = blob_filter_for_spec(src, filter_spec, device=device)

        enum = _transfer(
            src.odb,
            repo.odb,
            wants,
            depth=depth,
            blob_filter=blob_filter,
            sender_shallow=read_shallow(src),
        )
        shallow_boundary = enum.shallow_boundary
        kind, target = src.refs.head_target()
        head_branch = (
            target[len("refs/heads/") :]
            if kind == "symbolic" and target.startswith("refs/heads/")
            else None
        )

    updated = {}
    skipped = []
    for branch, oid in branch_tips.items():
        local_ref = f"refs/remotes/{remote_name}/{branch}"
        # Server-supplied names get the same refname-format rules the
        # receive-pack side enforces — a hostile/buggy server must not be
        # able to plant 'x.lock'/'..'/control-char names under refs/.
        try:
            check_ref_format(local_ref, require_refs_prefix=True)
        except RefError:
            skipped.append(branch)
            continue
        if repo.refs.get(local_ref) != oid:
            repo.refs.set(local_ref, oid, log_message=f"fetch {remote_name}")
            updated[local_ref] = oid
    for tag, oid in tag_tips.items():
        local_ref = f"refs/tags/{tag}"
        try:
            check_ref_format(local_ref, require_refs_prefix=True)
        except RefError:
            skipped.append(tag)
            continue
        if repo.refs.get(local_ref) is None:
            repo.refs.set(local_ref, oid, log_message=f"fetch {remote_name}")
            updated[local_ref] = oid
    if skipped:
        print(
            f"warning: ignored {len(skipped)} invalid remote ref name(s): "
            + ", ".join(repr(s) for s in skipped[:5]),
            file=sys.stderr,
        )

    _update_shallow(repo, shallow_boundary)

    # remote HEAD symref, so clone knows the default branch
    if head_branch is not None:
        head_path = os.path.join(
            repo.gitdir, "refs", "remotes", remote_name, "HEAD"
        )
        os.makedirs(os.path.dirname(head_path), exist_ok=True)
        with open(head_path, "w") as f:
            f.write(f"ref: refs/remotes/{remote_name}/{head_branch}\n")
    return updated


# -- push ------------------------------------------------------------------


def parse_refspec(repo, refspec):
    """'+src:dst' / 'src:dst' / 'src' / ':dst'(delete) -> (src, dst, force)."""
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


def _record_push_tracking(repo, remote_name, src_ref, dst_ref, new_oid, set_upstream):
    """Mirror a successful push into refs/remotes/<name>/* (+ upstream cfg)."""
    if not dst_ref.startswith("refs/heads/"):
        return
    track = f"refs/remotes/{remote_name}/{dst_ref[len('refs/heads/'):]}"
    repo.refs.set(track, new_oid, log_message="update by push")
    if set_upstream and src_ref.startswith("refs/heads/"):
        b = src_ref[len("refs/heads/") :]
        repo.config.set_many(
            {f"branch.{b}.remote": remote_name, f"branch.{b}.merge": dst_ref}
        )


def render_push_conflict(report):
    """The client-side rendering of a server's structured conflict report:
    the same hierarchical text a local ``kart merge`` prints for the same
    two commits (one renderer — docs/SERVING.md §6)."""
    from kart_tpu_torch.cli.merge_cmds import conflict_report_as_text

    ref = report.get("ref", "the remote branch")
    lines = [
        f"Push to {ref} rejected: merging your commit "
        f"{report.get('ours', '?')[:8]} with the remote tip "
        f"{report.get('theirs', '?')[:8]} results in "
        f"{report.get('conflicts_total', '?')} conflicts:",
    ]
    summary = (report.get("merge") or {}).get("kart.merge/v1", {}).get(
        "conflicts"
    )
    if summary:
        lines.append(conflict_report_as_text(summary).rstrip("\n"))
    lines.append(
        "Fetch, merge and resolve locally (`kart fetch` + `kart merge`), "
        "then push the result. Re-pushing unchanged commits will conflict "
        "again."
    )
    return "\n".join(lines)


def _push_network(repo, remote_name, net, refspecs, *, force, set_upstream):
    """Push over a wire transport (HTTP or ssh/stdio): client-side
    enumeration against the server's declared tips, compare-and-swap ref
    updates server-side. A CAS lost to a contending writer — or a tip that
    had already moved past us when we looked — is resolved by the
    *server's* auto-rebase (docs/SERVING.md §6): clean merges land without
    any client round-trip, real conflicts come back as one terminal
    structured report rendered like a local ``kart merge`` conflict."""
    # one push = one trace (see the matching scope in fetch())
    with tm.request_scope(verb="push", remote=remote_name):
        return _push_network_traced(
            repo, remote_name, net, refspecs, force=force,
            set_upstream=set_upstream,
        )


def _push_network_traced(repo, remote_name, net, refspecs, *, force,
                         set_upstream):
    from kart_tpu_torch.transport.http import HttpTransportError, have_closure

    try:
        info = net.ls_refs()
    except HttpTransportError as e:
        raise RemoteError(str(e))
    server_refs = {f"refs/heads/{b}": o for b, o in info["heads"].items()}
    server_refs.update({f"refs/tags/{t}": o for t, o in info["tags"].items()})
    # one reachability walk for all refspecs — the server's tips don't
    # change between them
    has_set = None

    updated = {}
    for spec in refspecs:
        src_name, dst_name, spec_force = parse_refspec(repo, spec)
        spec_force = spec_force or force
        dst_ref = (
            dst_name if dst_name.startswith("refs/") else f"refs/heads/{dst_name}"
        )
        try:
            if src_name is None:  # delete
                if dst_ref not in server_refs:
                    raise RemoteError(f"Remote ref does not exist: {dst_ref}")
                result = net.receive_pack(
                    [],
                    [
                        {
                            "ref": dst_ref,
                            "old": server_refs[dst_ref],
                            "new": None,
                            "force": spec_force,
                        }
                    ],
                )
                updated.update(result.get("updated", result))
                continue

            src_ref, new_oid = _resolve_push_source(repo, src_name)
            old_oid = server_refs.get(dst_ref)
            # No client-side fast-forward veto any more: a diverged or
            # stale push is sent with the observed tip as its CAS base and
            # the server merges or rejects with a structured report — the
            # client can't see contention that happens after this look
            # anyway, and pre-rejecting here is what forced the manual
            # pull/merge/re-push cycle the merge service removes.
            if has_set is None:
                # the server also provably holds everything our remote-
                # tracking refs name (we fetched it from there, or pushed
                # it there): without these, a diverged push against a tip
                # we never fetched finds none of the advertised oids in our
                # odb, computes an EMPTY closure, and re-uploads the whole
                # history. A server that has since rewound and gc'd those
                # objects rejects deterministically with "Push incomplete"
                # — far rarer than contention itself.
                known = [
                    oid
                    for _, oid in repo.refs.iter_refs(
                        f"refs/remotes/{remote_name}/"
                    )
                ]
                has_set = have_closure(
                    repo.odb,
                    list(server_refs.values()) + known,
                    info.get("shallow", ()),
                )
            enum = ObjectEnumerator(
                repo.odb,
                [new_oid],
                has=has_set.__contains__,
                sender_shallow=read_shallow(repo),
            )
            result = net.receive_pack(
                enum,
                [
                    {
                        "ref": dst_ref,
                        "old": old_oid,
                        "new": new_oid,
                        "force": spec_force,
                    }
                ],
                shallow=lambda: enum.shallow_boundary,
            )
            landed = result.get("updated", result)
            updated.update(landed)
            rebase = result.get("rebase") or {}
            if rebase.get("rebased"):
                tm.incr("transport.push_rebased")
        except HttpTransportError as e:
            if getattr(e, "conflict_report", None):
                raise RemoteError(render_push_conflict(e.conflict_report))
            raise RemoteError(str(e))
        # track the oid the server actually landed (a rebased push lands a
        # server-made merge commit, not our local tip) — but never a commit
        # this store doesn't hold: a dangling tracking ref would crash every
        # reader that resolves it. Falling back to our own commit leaves the
        # ref merely behind (it IS an ancestor of the true tip); the next
        # fetch fast-forwards it.
        track_oid = landed.get(dst_ref, new_oid)
        if track_oid is not None and not repo.odb.contains(track_oid):
            track_oid = new_oid
        _record_push_tracking(
            repo, remote_name, src_ref, dst_ref, track_oid, set_upstream
        )
    return updated


def push(repo, remote_name="origin", refspecs=(), *, force=False, set_upstream=False):
    """Push refs to the remote. Default: current branch to its same name.
    Returns {remote_ref: oid}."""
    remote = Remote(repo, remote_name)

    if not refspecs:
        branch = repo.refs.head_branch()
        if branch is None:
            raise RemoteError("Cannot push: HEAD is detached and no refspec given")
        refspecs = [f"{branch}:{branch}"]

    net = network_remote(remote.url, retry=_retry_policy(repo, remote_name))
    if net is not None:
        try:
            return _push_network(
                repo,
                remote_name,
                net,
                refspecs,
                force=force,
                set_upstream=set_upstream,
            )
        finally:
            net.close()
    dst = remote.open()

    updated = {}
    for spec in refspecs:
        src_name, dst_name, spec_force = parse_refspec(repo, spec)
        spec_force = spec_force or force
        dst_ref = (
            dst_name if dst_name.startswith("refs/") else f"refs/heads/{dst_name}"
        )

        if src_name is None:  # delete
            if dst.refs.get(dst_ref) is None:
                raise RemoteError(f"Remote ref does not exist: {dst_ref}")
            dst.refs.delete(dst_ref)
            updated[dst_ref] = None
            continue

        src_ref, new_oid = _resolve_push_source(repo, src_name)

        old_oid = dst.refs.get(dst_ref)
        if old_oid and not spec_force:
            # fast-forward check: remote tip must be known + an ancestor
            if not repo.odb.contains(old_oid) or not repo.is_ancestor(
                old_oid, new_oid
            ):
                raise RemoteError(
                    f"Push to {dst_ref} rejected (non-fast-forward); "
                    "fetch first or use --force"
                )

        enum = _transfer(
            repo.odb, dst.odb, [new_oid], sender_shallow=read_shallow(repo)
        )
        # pushing from a shallow clone truncates the remote's history too —
        # record the boundary there so its walkers know it's deliberate
        _update_shallow(dst, enum.shallow_boundary)
        dst.refs.set(dst_ref, new_oid, log_message=f"push from {repo.gitdir}")
        updated[dst_ref] = new_oid

        _record_push_tracking(
            repo, remote_name, src_ref, dst_ref, new_oid, set_upstream
        )
    return updated


# -- clone -----------------------------------------------------------------


def clone(
    url,
    directory,
    *,
    bare=False,
    depth=None,
    spatial_filter_spec=None,
    wc_location=None,
    do_checkout=True,
    branch=None,
    device=None,
):
    """Clone a repository. spatial_filter_spec (a ResolvedSpatialFilterSpec
    or None) makes this a filtered partial clone: non-matching feature blobs
    stay on the server, the remote becomes a promisor, and later reads of
    missing features fetch on demand (reference: kart/clone.py:108-153,
    kart/repo.py:269-343)."""
    directory = os.path.abspath(directory)
    repo = KartRepo.init_repository(directory, bare=bare)
    try:
        add_remote(repo, "origin", url)

        filter_spec = None
        if spatial_filter_spec is not None:
            filter_spec = spatial_filter_spec.filter_arg
            repo.config.set_many(
                {
                    "remote.origin.promisor": "true",
                    "remote.origin.partialclonefilter": "extension:spatial="
                    + filter_spec,
                    **spatial_filter_spec.config_items(),
                }
            )

        fetch(repo, "origin", depth=depth, filter_spec=filter_spec, device=device)

        # pick the branch to check out: requested, remote HEAD (the symref
        # fetch recorded), or first
        if branch is None:
            head_file = os.path.join(
                repo.gitdir, "refs", "remotes", "origin", "HEAD"
            )
            if os.path.exists(head_file):
                with open(head_file) as f:
                    target = f.read().strip()
                prefix = "ref: refs/remotes/origin/"
                if target.startswith(prefix):
                    branch = target[len(prefix) :]
        if branch is None:
            heads = [r for r, _ in repo.refs.iter_refs("refs/remotes/origin/")]
            branch = heads[0].split("/")[-1] if heads else "main"

        tip = repo.refs.get(f"refs/remotes/origin/{branch}")
        if tip is not None:
            repo.refs.set(f"refs/heads/{branch}", tip, log_message="clone")
            repo.config.set_many(
                {
                    f"branch.{branch}.remote": "origin",
                    f"branch.{branch}.merge": f"refs/heads/{branch}",
                }
            )
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
    except BaseException as e:
        import shutil

        # A transfer that died mid-fetch leaves a FETCH_RESUME marker and a
        # salvaged partial store — keep it: `kart fetch` in the directory
        # resumes from what arrived instead of recloning from zero. Every
        # other failure removes the half-made repo as before.
        if isinstance(e, (RemoteError, OSError)) and (
            repo.read_gitdir_file(FETCH_RESUME_FILE) is not None
        ):
            raise RemoteError(
                f"{e} — partial clone kept at {directory!r}; run `kart "
                f"fetch` there to resume the transfer"
            ) from e
        shutil.rmtree(repo.gitdir, ignore_errors=True)
        raise


# -- promisor fetch --------------------------------------------------------


def fetch_promised_blobs(repo, oids):
    """Backfill promised blobs from the promisor remote (reference:
    FetchPromisedBlobsProcess, kart/promisor_utils.py:75-124). Returns the
    number fetched."""
    oids = [o for o in oids if not repo.odb.contains(o)]
    if not oids:
        return 0
    promisor = None
    for name in repo.remotes():
        if repo.config.get_bool(f"remote.{name}.promisor"):
            promisor = Remote(repo, name)
            break
    if promisor is None:
        raise RemoteError("No promisor remote configured")
    net = network_remote(promisor.url, retry=_retry_policy(repo, promisor.name))
    if net is not None:
        from kart_tpu_torch.transport.http import HttpTransportError

        try:
            return net.fetch_blobs(repo, oids)
        except HttpTransportError as e:
            raise RemoteError(str(e))
        finally:
            net.close()
    src = promisor.open()
    fetched = 0
    with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as wire:

        def pull():
            for oid in oids:
                try:
                    yield src.odb.read_raw(oid)
                except ObjectMissing:
                    raise RemoteError(
                        f"Promisor remote {promisor.name!r} is missing promised "
                        f"object {oid}"
                    )

        write_pack(wire, pull())
        wire.seek(0)
        with repo.odb.bulk_pack():
            for obj_type, content in read_pack(wire):
                repo.odb.write_raw(obj_type, content)
                fetched += 1
    return fetched
