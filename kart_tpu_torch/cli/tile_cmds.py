"""``kart export tiles``: a zoom pyramid of vector tiles of one dataset at
any commit, built from its sidecar columns
(:func:`kart_tpu_torch.tiles.pyramid.export_pyramid`).

Counterpart of kart_tpu's ``cli/tile_cmds.py``: the same options, files,
stdout line, stderr warning and exit codes, but for the worker count
of the stdout line on the card. On the card the export encodes in this
process by default and projects each batch with K7; with ``--device cpu``
it keeps kart_tpu's default, a pool of workers that project with numpy
(``--workers 1`` encodes in this process there too). A refused export
prints ``Error: <message>`` and exits 2.
"""

import os
import sys

from kart_tpu_torch.cli.parser import Argument, Command, Group, Option

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused export: ``Error: <message>`` on stderr, exit 2."""


def commands():
    tiles = Command("tiles", [
        Argument("refish", required=False, default="HEAD"),
        Option("--dataset", dest="ds_path",
               help="Dataset to export (default: the repo's only dataset)."),
        Option("--zoom", dest="zoom_spec", default="0-4",
               help="Zoom level or range (Z or Z0-Z1).  [default: 0-4]"),
        Option("--output", "-o", dest="out_dir", metavar="DIRECTORY", dir_path=True,
               help="Output directory (default: ./tiles-<short-oid>)."),
        Option("--layers", dest="layers",
               help="Comma-separated layers to include: bin,geojson,ktb2,mvt,props"),
        Option("--max-features", dest="max_features", integer=True, metavar="INTEGER",
               help="Per-tile feature ceiling; over-full tiles are skipped (counted)."),
        Option("--workers", dest="workers", integer=True, metavar="INTEGER",
               help="Parallel encode workers (default: KART_EXPORT_WORKERS, else 1 "
                    "on the card, else the core count on a >=4-core box); 1 = serial "
                    "in-process, on the device."),
        Option("--strict", dest="strict", kind="flag",
               help="Fail if any tile exceeded the feature ceiling."),
    ], run_export_tiles, help="Export a zoom pyramid of vector tiles for REFISH (any commit).")
    return [Group("export", [], {"tiles": tiles},
                  help="Export repository data into derived read-serving artifacts.")]


def run_export_tiles(args, repo, device):
    from kart_tpu_torch import tiles
    from kart_tpu_torch.tiles.grid import parse_zoom_spec
    from kart_tpu_torch.tiles.pyramid import export_pyramid

    try:
        zooms = parse_zoom_spec(args.zoom_spec)
        commit_oid = tiles.resolve_tile_commit(repo, args.refish)
        ds_path = args.ds_path
        if ds_path is None:
            paths = repo.structure(args.refish).datasets.paths()
            if len(paths) != 1:
                raise _CliError(f"Repo has {len(paths)} datasets; pick one with --dataset "
                                f"({', '.join(paths) or 'none'})")
            ds_path = paths[0]
        source = tiles.source_for(repo, commit_oid, ds_path)
        out_dir = args.out_dir or os.path.join(".", f"tiles-{commit_oid[:12]}")
        stats = export_pyramid(source, zooms, out_dir, layers=tiles.normalise_layers(args.layers),
                               max_features=args.max_features, workers=args.workers,
                               device=device)
    except (_CliError, tiles.TileAddressError, tiles.TileEncodeError,
            tiles.TileSourceError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return INVALID_ARGUMENT
    skipped = stats["tiles_skipped"]
    if skipped and args.strict:
        shown = ", ".join(f"{z}/{x}/{y}" for z, x, y in skipped[:20])
        more = f" (+{len(skipped) - 20} more)" if len(skipped) > 20 else ""
        print(f"Error: --strict: {len(skipped)} tiles exceeded the feature ceiling "
              f"and were skipped — the pyramid is incomplete: {shown}{more}. "
              f"Raise --max-features / KART_TILE_MAX_FEATURES or export "
              f"deeper zooms.", file=sys.stderr)
        return INVALID_ARGUMENT
    print(f"Exported {stats['tiles_written']} tiles "
          f"({stats['features_out']} features, {stats['bytes_out']} bytes) "
          f"of {ds_path}@{commit_oid[:12]} to {out_dir} "
          f"[z{zooms[0]}-z{zooms[-1]}; {stats['tiles_empty']} empty, "
          f"{stats['tiles_too_large']} over the feature ceiling; "
          f"{stats['export_workers']} workers]")
    if skipped:
        print(f"warning: {len(skipped)} tiles skipped over the feature "
              f"ceiling — the pyramid is incomplete (use --strict to fail, "
              f"--max-features 0 to lift)", file=sys.stderr)
    return 0
