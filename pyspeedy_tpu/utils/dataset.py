"""A minimal xarray-like Dataset.

The reference API returns xarray Datasets; this environment has no xarray, so
the public API returns this lightweight equivalent: named variables with
dims/attrs, coordinates, NetCDF3 round-trip via scipy, merge on outer
coordinates, and the selection/serialization bits the reference workflows
(callbacks, tests) use.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Variable", "Dataset", "open_dataset", "merge"]


class Variable:
    def __init__(self, dims, data, attrs=None):
        self.dims = tuple(dims)
        self.data = np.asarray(data)
        self.attrs = dict(attrs or {})

    @property
    def values(self):
        return self.data

    @property
    def shape(self):
        return self.data.shape

    def __repr__(self):
        return f"Variable(dims={self.dims}, shape={self.data.shape})"


class Dataset:
    """Named variables + coordinates with CF-ish metadata."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars: dict[str, Variable] = {}
        self.coords: dict[str, Variable] = {}
        self.attrs = dict(attrs or {})
        for name, v in (coords or {}).items():
            self.coords[name] = v if isinstance(v, Variable) else Variable(
                (name,), np.atleast_1d(np.asarray(v)))
        for name, v in (data_vars or {}).items():
            if isinstance(v, Variable):
                self.data_vars[name] = v
            else:
                dims, data = v[0], v[1]
                attrs_ = v[2] if len(v) > 2 else None
                self.data_vars[name] = Variable(dims, data, attrs_)

    def __getitem__(self, name) -> Variable:
        if name in self.data_vars:
            return self.data_vars[name]
        return self.coords[name]

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def keys(self):
        return self.data_vars.keys()

    @property
    def variables(self):
        out = dict(self.coords)
        out.update(self.data_vars)
        return out

    # -- transformations -------------------------------------------------

    def transpose(self, *order):
        out = Dataset(coords=self.coords, attrs=self.attrs)
        for name, v in self.data_vars.items():
            dims = [d for d in order if d in v.dims]
            perm = tuple(v.dims.index(d) for d in dims)
            out.data_vars[name] = Variable(dims, v.data.transpose(perm), v.attrs)
        return out

    def reindex(self, **kwargs):
        """Reorder along a coordinate given explicit coordinate values."""
        out = Dataset(coords=self.coords, attrs=self.attrs)
        out.data_vars = dict(self.data_vars)
        for cname, new_vals in kwargs.items():
            old = self.coords[cname].data
            idx = np.array([int(np.argmin(np.abs(old - v))) for v in
                            np.asarray(new_vals)])
            out.coords[cname] = Variable((cname,), np.asarray(new_vals),
                                         self.coords[cname].attrs)
            for name, v in list(out.data_vars.items()):
                if cname in v.dims:
                    ax = v.dims.index(cname)
                    out.data_vars[name] = Variable(
                        v.dims, np.take(v.data, idx, axis=ax), v.attrs)
        return out

    def sel(self, **kwargs):
        out = Dataset(coords=dict(self.coords), attrs=self.attrs)
        out.data_vars = dict(self.data_vars)
        for cname, val in kwargs.items():
            cvals = self.coords[cname].data
            i = int(np.argmin(np.abs(cvals - val)))
            for name, v in list(out.data_vars.items()):
                if cname in v.dims:
                    ax = v.dims.index(cname)
                    dims = v.dims[:ax] + v.dims[ax + 1:]
                    out.data_vars[name] = Variable(
                        dims, np.take(v.data, i, axis=ax), v.attrs)
            out.coords.pop(cname, None)
        return out

    def squeeze(self, dim=None, drop=False):
        out = Dataset(coords=dict(self.coords), attrs=self.attrs)
        for name, v in self.data_vars.items():
            dims, data = list(v.dims), v.data
            for d in list(dims):
                if (dim is None or d == dim) and data.shape[dims.index(d)] == 1:
                    data = np.squeeze(data, axis=dims.index(d))
                    dims.remove(d)
            out.data_vars[name] = Variable(dims, data, v.attrs)
        if drop and dim is not None:
            out.coords.pop(dim, None)
        return out

    def drop_vars(self, names):
        if isinstance(names, str):
            names = [names]
        out = Dataset(coords=dict(self.coords), attrs=self.attrs)
        out.data_vars = {k: v for k, v in self.data_vars.items()
                         if k not in names}
        for n in names:
            out.coords.pop(n, None)
        return out

    # -- I/O --------------------------------------------------------------

    def to_netcdf(self, path, encoding=None):
        from scipy.io import netcdf_file
        enc = encoding or {}
        with netcdf_file(path, "w") as f:
            dim_sizes = {}
            for v in list(self.coords.values()) + list(self.data_vars.values()):
                for d, s in zip(v.dims, v.data.shape):
                    dim_sizes[d] = s
            for d, s in dim_sizes.items():
                f.createDimension(d, s)
            for name, v in {**self.coords, **self.data_vars}.items():
                dtype = enc.get(name, {}).get("dtype")
                data = v.data
                attrs = dict(v.attrs)
                if np.issubdtype(data.dtype, np.datetime64):
                    ref = data.min()
                    days = ((data - ref) / np.timedelta64(1, "D"))
                    data = days.astype("int32")
                    ref_dt = ref.astype("datetime64[s]").item()
                    attrs.setdefault(
                        "units",
                        "days since " + ref_dt.strftime("%Y-%m-%d %H:%M:%S"))
                    attrs.setdefault("calendar", "proleptic_gregorian")
                elif dtype == "int32":
                    data = data.astype("int32")
                elif data.dtype == np.float64 or dtype == "float32":
                    data = data.astype("float32")
                var = f.createVariable(name, data.dtype, v.dims)
                var[:] = data
                for k, val in attrs.items():
                    if val is not None:
                        setattr(var, k, val)

    def __repr__(self):
        lines = ["<pyspeedy_tpu.Dataset>"]
        lines.append("Coordinates: " + ", ".join(
            f"{k}({v.data.shape[0] if v.data.ndim else 1})"
            for k, v in self.coords.items()))
        for k, v in self.data_vars.items():
            lines.append(f"  {k} {v.dims} {v.data.shape}")
        return "\n".join(lines)


def open_dataset(path):
    """Open a NetCDF file (classic via scipy, NetCDF4/HDF5 via h5py)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"CDF"):
        return _open_netcdf3(path)
    return _open_netcdf4(path)


def _open_netcdf3(path):
    from scipy.io import netcdf_file
    ds = Dataset()
    with netcdf_file(path, mmap=False) as f:
        for name, var in f.variables.items():
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in var._attributes.items()}
            v = Variable(var.dimensions, np.array(var[:]), attrs)
            if name in f.dimensions and v.dims == (name,):
                ds.coords[name] = v
            else:
                ds.data_vars[name] = v
    return ds


def _open_netcdf4(path):
    # Optional dependency: only users' own NetCDF-4 files need it (every
    # bundled file is NetCDF-3, which scipy reads).
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is a NetCDF-4/HDF5 file; reading it needs the h5py "
            "package (or convert the file to NetCDF-3).") from e
    ds = Dataset()
    with h5py.File(path, "r") as f:
        def dims_of(obj):
            labels = []
            for i, dim in enumerate(obj.dims):
                label = None
                if len(dim) > 0:
                    label = dim[0].name.rsplit("/", 1)[-1]
                labels.append(label or f"dim_{i}")
            return tuple(labels)

        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            attrs = {}
            for k, v in obj.attrs.items():
                if k.startswith("_Netcdf4") or k in ("DIMENSION_LIST",
                                                     "CLASS", "NAME",
                                                     "REFERENCE_LIST"):
                    continue
                attrs[k] = v.decode() if isinstance(v, bytes) else v
            v = Variable(dims_of(obj), obj[()], attrs)
            if v.dims == (name,):
                ds.coords[name] = v
            else:
                ds.data_vars[name] = v
    return ds


def merge(datasets, join="outer", compat="no_conflicts"):
    """Merge datasets on their coordinates (supports the callback use case:
    same variables at disjoint time/ens coordinate values)."""
    datasets = list(datasets)
    if not datasets:
        return Dataset()
    out = Dataset(attrs=datasets[0].attrs)

    # Union of coordinates, preserving first-seen order (so reversed-lev
    # exports keep their coordinate ordering, like xarray's merge).
    for ds in datasets:
        for cname, cv in ds.coords.items():
            if cname not in out.coords:
                out.coords[cname] = Variable(cv.dims, cv.data.copy(), cv.attrs)
            else:
                have = out.coords[cname].data
                extra = [x for x in cv.data if not np.isin(x, have)]
                if extra:
                    out.coords[cname] = Variable(
                        cv.dims, np.concatenate([have, np.asarray(extra)]),
                        cv.attrs)

    def positions(coord_vals, member_vals):
        pos = np.empty(len(member_vals), dtype=np.int64)
        for i, val in enumerate(member_vals):
            hits = np.nonzero(coord_vals == val)[0]
            pos[i] = hits[0]
        return pos

    for ds in datasets:
        for name, v in ds.data_vars.items():
            shape = tuple(
                out.coords[d].data.shape[0] if d in out.coords else s
                for d, s in zip(v.dims, v.data.shape))
            if name not in out.data_vars:
                out.data_vars[name] = Variable(
                    v.dims, np.full(shape, np.nan, dtype=v.data.dtype),
                    v.attrs)
            tgt = out.data_vars[name]
            idx = []
            for d, s in zip(v.dims, v.data.shape):
                if d in out.coords and d in ds.coords:
                    idx.append(positions(out.coords[d].data,
                                         ds.coords[d].data))
                else:
                    idx.append(np.arange(s))
            tgt.data[np.ix_(*idx)] = v.data
    return out
