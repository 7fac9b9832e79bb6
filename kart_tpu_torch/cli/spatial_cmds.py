"""``kart spatial-filter``: ``index`` builds or updates the feature envelope
index (:func:`kart_tpu_torch.spatial_filter.index.update_spatial_filter_index`),
and ``resolve`` shows a filter spec (given, or the repo's own) with its CRS,
geometry and EPSG:4326 envelope.

Counterpart of kart_tpu's ``cli/spatial_cmds.py``: the same options, lines
and JSON document. A malformed spec prints ``Error: <message>`` and exits
2. Both commands are host work: neither launches a kernel.
"""

import sys

from kart_tpu_torch.cli.parser import Argument, Command, Group, Option
from kart_tpu_torch.diff.output import dump_json_output

INVALID_ARGUMENT = 2


def commands():
    index = Command("index", [
        Option("--clear", dest="clear", kind="flag",
               help="Discard the index and rebuild from scratch"),
        Option("--dry-run", dest="dry_run", kind="flag",
               help="Index but don't save the result"),
    ], run_index, help="Build or update the feature envelope index (enables fast "
                       "spatially-filtered clones from this repo).")
    resolve = Command("resolve", [
        Option("-o", "--output-format", dest="output_format", choices=["text", "json"],
               default="text"),
        Argument("spec", required=False),
    ], run_resolve, help="Resolve a spatial filter spec (or this repo's configured filter) "
                         "and show its geometry, CRS and EPSG:4326 envelope.")
    return [Group("spatial-filter", [], {"index": index, "resolve": resolve},
                  help="Work with spatial filters and the feature envelope index.")]


def run_index(args, repo, device):
    from kart_tpu_torch.spatial_filter.index import update_spatial_filter_index

    n_features, n_commits = update_spatial_filter_index(repo, clear=args.clear,
                                                        dry_run=args.dry_run)
    print(f"Indexed {n_features} feature envelopes over {n_commits} new commits")
    return 0


def run_resolve(args, repo, device):
    from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec, SpatialFilterError

    try:
        if args.spec:
            resolved = ResolvedSpatialFilterSpec.from_spec_string(args.spec)
        else:
            resolved = ResolvedSpatialFilterSpec.from_repo_config(repo)
    except SpatialFilterError as e:
        print(f"Error: {e}", file=sys.stderr)
        return INVALID_ARGUMENT

    if resolved.match_all:
        if args.output_format == "json":
            dump_json_output({"kart.spatialfilter/v1": None}, "-")
        else:
            print("No spatial filter is configured (all features match)")
        return 0

    w, s, e, n = resolved.envelope_wsen_4326
    if args.output_format == "json":
        dump_json_output({
            "kart.spatialfilter/v1": {
                "crs": resolved.crs_spec,
                "geometry": resolved.geometry.to_wkt(),
                "envelope4326": {"w": w, "s": s, "e": e, "n": n},
            }
        }, "-")
    else:
        print(f"CRS: {resolved.crs_spec}")
        print(f"Geometry: {resolved.geometry.to_wkt()[:120]}")
        print(f"Envelope (EPSG:4326 w,s,e,n): {w:.7f},{s:.7f},{e:.7f},{n:.7f}")
    return 0
