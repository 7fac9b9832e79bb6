"""NTv2 datum grid shifts.

Counterpart of kart_tpu's ``gridshift.py``: the ``.gsb`` format read
natively (little- or big-endian, subgrids in hierarchy order) and applied
as a vectorized bilinear interpolation, plugged into the datum-shift stage
of :class:`kart_tpu_torch.crs.Transform` through a registry of its own.

No grids ship with the package. Point ``KART_NTV2_GRID_DIR`` at a directory
of ``.gsb`` files (kart_tpu reads the same variable), or call
:func:`register_grid`. A registered grid applies when a Transform's datum
name matches the grid's ``SYSTEM_F`` (or the name it was registered under,
or a file's stem); otherwise the Helmert/TOWGS84 path runs.

NTv2 layout (binary, little- or big-endian, detected from NUM_OREC):
  overview header: 11 records x 16 bytes ("NUM_OREC" i32, "NUM_SREC",
  "NUM_FILE", "GS_TYPE ", "VERSION ", "SYSTEM_F", "SYSTEM_T", "MAJOR_F"
  f64, "MINOR_F", "MAJOR_T", "MINOR_T")
  per subgrid: 11 records ("SUB_NAME", "PARENT", "CREATED", "UPDATED",
  "S_LAT" f64, "N_LAT", "E_LONG", "W_LONG", "LAT_INC", "LONG_INC",
  "GS_COUNT" i32) then GS_COUNT nodes of 4 float32 (lat shift, lon shift,
  accuracies) in seconds. Longitude values are positive WEST; nodes run
  south-to-north rows, east-to-west within a row.
"""

import os
import struct

import numpy as np


class GridShiftError(ValueError):
    pass


class SubGrid:
    __slots__ = (
        "name",
        "parent",
        "s_lat",
        "n_lat",
        "e_long",
        "w_long",
        "lat_inc",
        "lon_inc",
        "lat_shift",
        "lon_shift",
        "n_rows",
        "n_cols",
    )


class NTv2Grid:
    """A parsed .gsb file: subgrids + vectorized bilinear lookup."""

    def __init__(self, system_from, system_to, subgrids):
        self.system_from = system_from
        self.system_to = system_to
        # Process coarse->fine so finer (child) subgrids overwrite their
        # parents in shift(). The format does NOT guarantee parents are
        # listed first (PROJ resolves the hierarchy via the PARENT field),
        # so order by hierarchy depth — stable, so sibling file order is
        # kept. Unknown/cyclic parents are treated as roots.
        depth_memo = {}
        by_name = {sg.name: sg for sg in subgrids}

        def depth(sg, seen=()):
            if sg.name in depth_memo:
                return depth_memo[sg.name]
            parent = by_name.get(getattr(sg, "parent", "NONE"))
            d = (
                0
                if parent is None or sg.name in seen
                else depth(parent, seen + (sg.name,)) + 1
            )
            depth_memo[sg.name] = d
            return d

        self.subgrids = sorted(subgrids, key=depth)

    @classmethod
    def open(cls, path):
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < 11 * 16:
            raise GridShiftError(f"{path}: too short for an NTv2 overview header")

        # endianness: NUM_OREC's value is a small int (11)
        for endian in ("<", ">"):
            (n_orec,) = struct.unpack_from(endian + "i", data, 8)
            if 0 < n_orec < 1000:
                break
        else:
            raise GridShiftError(f"{path}: cannot determine NTv2 endianness")

        def rec_name(off):
            return data[off : off + 8].decode("ascii", "replace").strip()

        def rec_i32(off):
            return struct.unpack_from(endian + "i", data, off + 8)[0]

        def rec_f64(off):
            return struct.unpack_from(endian + "d", data, off + 8)[0]

        def rec_str(off):
            return data[off + 8 : off + 16].decode("ascii", "replace").strip()

        if rec_name(0) != "NUM_OREC":
            raise GridShiftError(f"{path}: not an NTv2 file")
        n_srec = rec_i32(16)
        n_file = rec_i32(32)
        gs_type = rec_str(3 * 16).upper()
        if gs_type != "SECONDS":
            # MINUTES/DEGREES grids exist in the wild; silently scaling them
            # as seconds would be 60x/3600x wrong — fail loudly (PROJ does)
            raise GridShiftError(
                f"{path}: GS_TYPE {gs_type!r} not supported (SECONDS only)"
            )
        system_f = rec_str(5 * 16)
        system_t = rec_str(6 * 16)

        pos = n_orec * 16
        subgrids = []
        for _ in range(n_file):
            fields = {}
            for r in range(n_srec):
                off = pos + r * 16
                name = rec_name(off)
                if name in ("S_LAT", "N_LAT", "E_LONG", "W_LONG", "LAT_INC", "LONG_INC"):
                    fields[name] = rec_f64(off)
                elif name == "GS_COUNT":
                    fields[name] = rec_i32(off)
                else:
                    fields[name] = rec_str(off)
            pos += n_srec * 16
            count = fields["GS_COUNT"]
            try:
                nodes = np.frombuffer(
                    data, dtype=endian + "f4", count=count * 4, offset=pos
                ).reshape(count, 4)
            except ValueError as err:
                # truncated node section: keep the module's error contract
                raise GridShiftError(
                    f"{path}: truncated node data in subgrid "
                    f"{fields.get('SUB_NAME', '?')!r}: {err}"
                )
            pos += count * 16

            sg = SubGrid()
            sg.name = fields.get("SUB_NAME", "")
            sg.parent = fields.get("PARENT", "NONE")
            sg.s_lat = fields["S_LAT"]
            sg.n_lat = fields["N_LAT"]
            sg.e_long = fields["E_LONG"]
            sg.w_long = fields["W_LONG"]
            sg.lat_inc = fields["LAT_INC"]
            sg.lon_inc = fields["LONG_INC"]
            sg.n_cols = int(round((sg.w_long - sg.e_long) / sg.lon_inc)) + 1
            sg.n_rows = int(round((sg.n_lat - sg.s_lat) / sg.lat_inc)) + 1
            if sg.n_rows * sg.n_cols != count:
                raise GridShiftError(
                    f"{path}: subgrid {sg.name!r} node count mismatch "
                    f"({sg.n_rows}x{sg.n_cols} != {count})"
                )
            sg.lat_shift = nodes[:, 0].reshape(sg.n_rows, sg.n_cols)
            sg.lon_shift = nodes[:, 1].reshape(sg.n_rows, sg.n_cols)
            subgrids.append(sg)
        return cls(system_f, system_t, subgrids)

    def shift(self, lon_deg, lat_deg, inverse=False):
        """Apply the grid: source-datum lon/lat (degrees, east-positive) ->
        target datum. Points outside every subgrid pass through unchanged
        (fail open, like PROJ). ``inverse`` applies target->source with
        three fixed-point refinement rounds."""
        lon = np.asarray(lon_deg, dtype=np.float64)
        lat = np.asarray(lat_deg, dtype=np.float64)
        if inverse:
            # first guess: subtract the forward shift at the target point,
            # then refine so forward(result) lands back on the input
            glon, glat = lon, lat
            for _ in range(3):
                flon, flat = self.shift(glon, glat)
                glon = glon - (flon - lon)
                glat = glat - (flat - lat)
            return glon, glat

        dlat = np.zeros_like(lat)
        dlon = np.zeros_like(lon)
        done = np.zeros(lat.shape, dtype=bool)
        # NTv2 longitudes are positive WEST
        lon_w = -lon
        # later (finer, child) subgrids win: subgrids are hierarchy-ordered
        # at construction (roots first), so children overwrite parents
        for sg in self.subgrids:
            inside = (
                (lat >= sg.s_lat / 3600.0)
                & (lat <= sg.n_lat / 3600.0)
                & (lon_w * 3600.0 >= sg.e_long)
                & (lon_w * 3600.0 <= sg.w_long)
            )
            if not np.any(inside):
                continue
            row = (lat * 3600.0 - sg.s_lat) / sg.lat_inc
            col = (lon_w * 3600.0 - sg.e_long) / sg.lon_inc
            r0 = np.clip(np.floor(row).astype(np.int64), 0, sg.n_rows - 2)
            c0 = np.clip(np.floor(col).astype(np.int64), 0, sg.n_cols - 2)
            fr = np.clip(row - r0, 0.0, 1.0)
            fc = np.clip(col - c0, 0.0, 1.0)

            def interp(table):
                v00 = table[r0, c0]
                v01 = table[r0, c0 + 1]
                v10 = table[r0 + 1, c0]
                v11 = table[r0 + 1, c0 + 1]
                return (
                    v00 * (1 - fr) * (1 - fc)
                    + v01 * (1 - fr) * fc
                    + v10 * fr * (1 - fc)
                    + v11 * fr * fc
                )

            dlat = np.where(inside, interp(sg.lat_shift), dlat)
            dlon = np.where(inside, interp(sg.lon_shift), dlon)
            done |= inside

        out_lat = lat + np.where(done, dlat / 3600.0, 0.0)
        # shifts are positive west: an eastward-positive longitude decreases
        out_lon = lon - np.where(done, dlon / 3600.0, 0.0)
        return out_lon, out_lat


# -- registry ---------------------------------------------------------------

_REGISTRY = {}  # normalised datum/system name -> NTv2Grid
_dir_scanned = False


def _norm(name):
    return "".join(ch for ch in (name or "").upper() if ch.isalnum())


def register_grid(name, grid):
    """Make ``grid`` apply to Transforms whose source datum matches
    ``name`` (case/punctuation-insensitive)."""
    _REGISTRY[_norm(name)] = grid


def clear_grids():
    global _dir_scanned
    _REGISTRY.clear()
    _dir_scanned = False


def _scan_env_dir():
    global _dir_scanned
    if _dir_scanned:
        return
    _dir_scanned = True
    d = os.environ.get("KART_NTV2_GRID_DIR")
    if not d or not os.path.isdir(d):
        return
    import logging

    for fn in sorted(os.listdir(d)):
        if not fn.lower().endswith(".gsb"):
            continue
        try:
            grid = NTv2Grid.open(os.path.join(d, fn))
        except Exception as e:
            # truncated/corrupt files raise ValueError/struct.error from the
            # binary decode — one bad grid must not poison every Transform
            logging.getLogger(__name__).warning(
                "ignoring NTv2 grid %s: %s", fn, e
            )
            continue
        # registered under the declared source system AND the filename stem,
        # so alternate datum spellings can be aliased by naming the file;
        # explicit register_grid() calls made before the lazy scan win
        _REGISTRY.setdefault(_norm(grid.system_from), grid)
        _REGISTRY.setdefault(_norm(os.path.splitext(fn)[0]), grid)


def grid_for_datum(datum_name):
    """-> NTv2Grid for the datum, or None. Scans $KART_NTV2_GRID_DIR once."""
    _scan_env_dir()
    if not _REGISTRY:
        return None
    return _REGISTRY.get(_norm(datum_name))
