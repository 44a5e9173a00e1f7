"""The Speedy model — public API.

Mirrors the reference's `pyspeedy.speedy` surface (Speedy, SpeedyEns;
pyspeedy/speedy.py:40-597): same constructor signature, dict-style state
access with registry names and Fortran-order shapes, set_bc contract,
run(callbacks), grid/spectral conversions, CF-metadata export, and error-code
to exception mapping.

Internals: the state is a pytree of jnp arrays, a day of steps is
one jitted lax.scan, and ensembles batch the member axis with vmap instead of
the reference's OpenMP threads.
"""

from __future__ import annotations

import dataclasses
import math
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np

from . import DEFAULT_OUTPUT_VARS, example_bc_file, example_sst_anomaly_file
from .error_codes import ERROR_CODES, E_DIAGNOSTICS_OUTSIDE_RANGE
from .models import model as M
from .models import prognostics as prog
from .models.diagnostics import check_diagnostics
from .params import ModelParams, T30L8
from .registry import REGISTRY, from_api_array, resolve_dims, to_api_array
from .utils.calendar import ModelCalendar
from .utils.dataset import Dataset, Variable, merge, open_dataset

__all__ = ["Speedy", "SpeedyEns", "MODEL_STATE_DEF"]

# Checkpoint (.npz) format version: bump when the stored layout of any state
# field changes (v2: 'tr' stored as (t_levs, ntr, kx, mx, nx); v3: spectral
# fields stored as real (2, ...) pairs instead of complex — ops/spectral.py;
# v4: the cal metadata grew a 7th element, the sub-minute seconds counter —
# v3 checkpoints still load, their seconds default to 0).
_CHECKPOINT_VERSION = 4
_CHECKPOINT_LOADABLE = (3, 4)

# Exported for API parity with pyspeedy.speedy.MODEL_STATE_DEF
MODEL_STATE_DEF = {
    name: {
        "dtype": spec.kind,
        "dims": spec.dims,
        "units": spec.units,
        "desc": spec.long_name,
        "std_name": spec.std_name,
        "alt_name": spec.alt_name,
        "nc_dims": list(spec.nc_dims) if spec.nc_dims else None,
        "time_dim": spec.time_dim,
    }
    for name, spec in REGISTRY.items()
}


def _add_months(date: datetime, months: int) -> datetime:
    m = date.month - 1 + months
    return date.replace(year=date.year + m // 12, month=m % 12 + 1)


class Speedy:
    """Speedy model instance (reference: pyspeedy/speedy.py:40-483)."""

    def __init__(self, start_date=datetime(1982, 1, 1),
                 end_date=datetime(1982, 1, 2), member=None,
                 params: ModelParams = T30L8):
        self.member_id = member
        self.is_ensemble_member = member is not None
        self.params = params
        self._state = None
        self._consts = None
        self._run_steps_fn = None
        self._current_step = 0
        self._initialized_bc = False
        self._initialized_ssta = False
        self._sst_anom_data = None
        self.set_params(start_date=start_date, end_date=end_date)

    # -- control parameters ------------------------------------------------

    def set_params(self, start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2)):
        if start_date > end_date:
            raise ValueError("The start date should be lower than the en date.")
        self.start_date = start_date
        self.end_date = end_date
        self.current_date = start_date
        self._cal = ModelCalendar.from_datetime(start_date,
                                               nsteps=self.params.nsteps)
        self.n_months = ((end_date.year - start_date.year) * 12
                         + (end_date.month - start_date.month) + 1)

    def get_current_step(self):
        return self._current_step

    @property
    def _dt_step(self):
        # dt follows the configured steps/day (reference: fixed 2400 s, T30)
        return timedelta(seconds=3600 * 24 / self.params.nsteps)

    # -- state access ------------------------------------------------------

    def _spec_for(self, var_name):
        spec = REGISTRY.get(var_name)
        if spec is None:
            raise AttributeError(
                f"The state variable '{var_name}' does not exist.")
        return spec

    def __getitem__(self, var_name):
        if var_name == "current_step":
            return self._current_step
        spec = self._spec_for(var_name)
        # A writable host copy, like the reference's f2py getters
        # (speedy_driver.f90 get_* copy out).
        val = self._state[var_name]
        arr = val if isinstance(val, tuple) else np.array(val)
        out = to_api_array(spec, arr)
        return np.ascontiguousarray(out) if out.ndim else out

    def get_shape(self, var_name):
        spec = self._spec_for(var_name)
        n_months = self._sst_anom_months() if spec.time_dim else None
        return resolve_dims(self.params, spec.dims, n_months=n_months)

    def _sst_anom_months(self):
        if self._state is not None and "sst_anom" in self._state:
            return self._state["sst_anom"].shape[0] - 2
        return self.n_months

    def __setitem__(self, var_name, value):
        if var_name == "current_step":
            self._current_step = int(value)
            return
        spec = self._spec_for(var_name)
        if spec.dims:
            value = np.asarray(getattr(value, "values", value))
            if self.get_shape(var_name) != value.shape:
                raise ValueError("Array shape missmatch")
            internal = from_api_array(spec, value)
            cur = self._state[var_name]
            if isinstance(internal, tuple):
                self._state[var_name] = tuple(
                    jnp.asarray(a, dtype=c.dtype)
                    for a, c in zip(internal, cur))
            else:
                self._state[var_name] = jnp.asarray(internal, dtype=cur.dtype)
        else:
            self._state[var_name] = jnp.asarray(
                value, dtype=self._state[var_name].dtype)

    # -- initialization ----------------------------------------------------

    def set_bc(self, bc_file=None, sst_anomaly=None):
        """Set boundary conditions and initialize the model (reference
        contract: pyspeedy/speedy.py:217-301). See that docstring for the
        expected NetCDF fields (orog, lsm, alb, vegl, vegh, stl, snowd,
        swl1-3, sst, icec; anomalies: ssta)."""
        if self._initialized_bc:
            raise RuntimeError(
                "The model was already initialized. Create a new instance if "
                "you need different boundary conditions.")

        self._set_sst_anomalies(sst_anomaly=sst_anomaly)

        if bc_file is None:
            bc_file = example_bc_file()
        import os
        if not os.path.isfile(bc_file):
            raise RuntimeError(
                "The boundary conditions file does not exist.\n"
                f"File: {bc_file}")

        ds = open_dataset(bc_file)

        def lonlat(name):
            # (lon, lat[, month]) -> internal ([month,] lat, lon)
            data = np.asarray(ds[name].values, dtype=np.float64)
            return np.moveaxis(data, (0, 1), (-1, -2))

        host_bc = {
            "orog": lonlat("orog"),
            "fmask_orig": lonlat("lsm"),
            "alb0": lonlat("alb"),
            "veg_high": lonlat("vegh"),
            "veg_low": lonlat("vegl"),
            "stl12": lonlat("stl"),
            "snowd12": lonlat("snowd"),
            "soil_wc_l1": lonlat("swl1"),
            "soil_wc_l2": lonlat("swl2"),
            "soil_wc_l3": lonlat("swl3"),
            "sst12": lonlat("sst"),
            "sea_ice_frac12": lonlat("icec"),
            "sst_anom": self._sst_anom_data,
        }

        consts, geom_np = M.build_consts_cached(self.params)
        host_bc["_geom_np"] = geom_np
        self._consts = consts
        state = M.allocate_state(
            self.params, n_months=self._sst_anom_data.shape[0] - 2)
        if self.params.sppt_on:
            # Distinct, reproducible stochastic-physics stream per member
            # (raw key data — see physics/sppt.as_typed_key)
            import jax
            state["sppt_key"] = jax.random.key_data(jax.random.fold_in(
                jax.random.key(0), self.member_id or 0))
        # push raw soil fields for registry access
        state["soil_wc_l3"] = jnp.asarray(host_bc["soil_wc_l3"])
        cal = ModelCalendar.from_datetime(self.start_date,
                                         nsteps=self.params.nsteps)
        self._state = M.initialize(consts, state, host_bc, cal)
        self._cal = cal
        self._current_step = 0
        self._run_steps_fn = {}
        self.spectral2grid()
        self._initialized_bc = True

    def _set_sst_anomalies(self, sst_anomaly=None):
        """Load SST anomalies covering [start-1 month, end+1 month]
        (reference: pyspeedy/speedy.py:303-373)."""
        if self._initialized_ssta:
            raise RuntimeError(
                "The SST anomaly was already initialized."
                " Create a new instance if you need different boundary "
                "conditions.")
        if sst_anomaly is None:
            sst_anomaly = example_sst_anomaly_file()

        if isinstance(sst_anomaly, str):
            import os
            if not os.path.isfile(sst_anomaly):
                raise RuntimeError(
                    "The SST anomaly file does not exist.\n"
                    f"File: {sst_anomaly}")
            ds = open_dataset(sst_anomaly)
        elif isinstance(sst_anomaly, Dataset):
            ds = sst_anomaly
        else:
            raise TypeError(
                f"Unsupported sst_anomaly input: {type(sst_anomaly)}")

        start_date = _add_months(
            self.start_date.replace(day=1, hour=0, minute=0, second=0,
                                    microsecond=0), -1)
        end_date = _add_months(
            self.end_date.replace(day=1, hour=0, minute=0, second=0,
                                  microsecond=0), 1) + timedelta(days=1)

        times = np.asarray(ds["time"].values)
        tvar = ds["time"]
        if not np.issubdtype(times.dtype, np.datetime64):
            units = tvar.attrs.get("units", "")
            times = _decode_cf_time(times, units)
        sel = (times >= np.datetime64(start_date)) \
            & (times <= np.datetime64(end_date))

        expected_months = ((end_date.year - start_date.year) * 12
                           + (end_date.month - start_date.month) + 1)
        missing_months = expected_months - int(sel.sum())
        if missing_months > 0:
            raise RuntimeError(
                f"{missing_months} months are missing in the SST anomalies "
                "file for the period: "
                + start_date.strftime("%Y/%m/%d") + " , "
                + end_date.strftime("%Y/%m/%d") + ".\n ")

        ssta = np.asarray(ds["ssta"].values, dtype=np.float64)
        tax = ds["ssta"].dims.index("time")
        ssta = np.take(ssta, np.nonzero(sel)[0], axis=tax)
        # to internal layout (time, lat, lon)
        dims = ds["ssta"].dims
        order = [dims.index("time"), dims.index("lat"), dims.index("lon")]
        ssta = np.transpose(ssta, order)
        self._sst_anom_data = ssta
        self._initialized_ssta = True

    # -- stepping ----------------------------------------------------------

    def _advance(self, n_steps):
        """Advance n_steps (one jitted scan). When the chunk is a multiple of
        3 the scan specializes statically on the nstrad shortwave phase."""
        phase = self._current_step % 3 if n_steps % 3 == 0 else None
        run = M.make_run_steps_cached(self._consts, phase)
        ctx, self._cal = M.build_step_ctx(self._cal, self._current_step,
                                          n_steps)
        self._state = run(self._state, ctx)
        self._current_step += n_steps
        self.current_date += self._dt_step * n_steps

    def _raise_if_failed(self):
        if bool(self._state["error_flag"]):
            raise RuntimeError(ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE])

    def run(self, callbacks=None):
        """Run from start_date to end_date, invoking callbacks
        (reference: pyspeedy/speedy.py:375-405)."""
        if callbacks is None:
            callbacks = []
        if not self._initialized_bc:
            raise RuntimeError(
                "The SPEEDY model was not initialized. Call the `set_bc` "
                "method to initialize the model.")

        self.current_date = self.start_date
        total = round((self.end_date - self.current_date) / self._dt_step)
        chunk = 1
        if total > 0:
            intervals = [cb.interval for cb in callbacks
                         if getattr(cb, "interval", None)]
            chunk = math.gcd(*intervals) if intervals else total

        done = 0
        while done < total:
            n = min(chunk, total - done)
            self._advance(n)
            self._raise_if_failed()
            done += n
            for callback in callbacks:
                callback(self)

    # -- conversions and export -------------------------------------------

    _GLOBAL_JIT_CACHE = {}

    def _jitted(self, name, fn):
        key = (id(self._consts), name)
        cache = Speedy._GLOBAL_JIT_CACHE
        if key not in cache:
            import jax
            cache[key] = jax.jit(fn)
        return cache[key]

    def grid2spectral(self):
        consts = self._consts
        self._state = self._jitted(
            "g2s", lambda st: prog.grid2spectral(consts, st))(self._state)

    def spectral2grid(self):
        consts = self._consts
        self._state = self._jitted(
            "s2g", lambda st: prog.spectral2grid(consts, st))(self._state)

    def apply_grid_filter(self):
        """Spectrally truncate the grid-space prognostic mirrors (reference
        driver: apply_grid_filter, speedy_driver.f90)."""
        self._state = prog.grid_filter_prognostics(self._consts, self._state)

    # -- checkpoint / restore ---------------------------------------------

    def save_checkpoint(self, path):
        """Save the full model state (a flat pytree of arrays) plus the
        stepping metadata. The reference has no binary restart files — its
        mechanism is full state exposure through get/set (SURVEY.md §5);
        this adds a one-call save/restore on top of the same state dict."""
        arrays = {k: (np.stack([np.asarray(a) for a in v])
                      if isinstance(v, tuple) else np.asarray(v))
                  for k, v in self._state.items()}
        meta = dict(
            format_version=_CHECKPOINT_VERSION,
            current_step=self._current_step,
            cal=(self._cal.year, self._cal.month, self._cal.day,
                 self._cal.hour, self._cal.minute, self._cal.month_idx,
                 self._cal.second),
            current_date=self.current_date.isoformat(),
        )
        np.savez_compressed(path, __meta__=np.asarray([repr(meta)]), **arrays)

    def load_checkpoint(self, path):
        """Restore a state saved by save_checkpoint. The model must already
        be initialized (set_bc) with the same configuration."""
        import ast

        with np.load(path, allow_pickle=False) as data:
            meta = ast.literal_eval(str(data["__meta__"][0]))
            version = meta.get("format_version", 1)
            if version not in _CHECKPOINT_LOADABLE:
                raise RuntimeError(
                    f"Checkpoint format version {version} is not supported "
                    f"(current: {_CHECKPOINT_VERSION}, loadable: "
                    f"{_CHECKPOINT_LOADABLE}). Versions 1-2 stored spectral "
                    "fields in older layouts; regenerate the checkpoint "
                    "with this version.")
            for k in self._state:
                if k in data.files:
                    cur = self._state[k]
                    if isinstance(cur, tuple):
                        self._state[k] = tuple(
                            jnp.asarray(data[k][i], dtype=cur[i].dtype)
                            for i in range(len(cur)))
                    else:
                        self._state[k] = jnp.asarray(data[k], dtype=cur.dtype)
        self._current_step = int(meta["current_step"])
        y, m, d, h, mi, midx, *rest = meta["cal"]
        self._cal = ModelCalendar(y, m, d, h, mi, month_idx=midx,
                                  nsteps=self.params.nsteps,
                                  second=rest[0] if rest else 0)
        self.current_date = datetime.fromisoformat(meta["current_date"])

    def check(self):
        """Diagnostics range check (reference: pyspeedy/speedy.py:479-483)."""
        if bool(check_diagnostics(self._consts, self._state, 0)):
            raise RuntimeError(ERROR_CODES[E_DIAGNOSTICS_OUTSIDE_RANGE])

    def to_dataframe(self, variables=None):
        """Export the current state as a CF-metadata Dataset
        (reference: pyspeedy/speedy.py:415-477)."""
        if variables is None:
            variables = DEFAULT_OUTPUT_VARS

        self.spectral2grid()
        data_vars = {}
        for var in variables:
            spec = REGISTRY[var]
            dims = list(spec.nc_dims) + ["time"]
            var_data = self[var][..., None].astype("float32")
            if self.is_ensemble_member:
                dims = dims + ["ens"]
                var_data = var_data[..., None]
            attrs = {"units": spec.units, "long_name": spec.long_name,
                     "standard_name": spec.std_name}
            data_vars[spec.alt_name] = Variable(dims, var_data, attrs)

        coords = {
            "lon": Variable(("lon",), self["lon"],
                            {"units": "degrees_east", "long_name": "longitude",
                             "standard_name": "lon", "axis": "X"}),
            "lat": Variable(("lat",), self["lat"],
                            {"units": "degrees_north",
                             "long_name": "latitude",
                             "standard_name": "lat", "axis": "Y"}),
            "lev": Variable(("lev",), self["lev"],
                            {"long_name": "Vertical sigma coordinate",
                             "standard_name": "lev"}),
            "time": Variable(("time",),
                             np.array([np.datetime64(self.current_date)]),
                             {"axis": "T", "standard_name": "time"}),
        }
        if self.is_ensemble_member:
            coords["ens"] = Variable(("ens",),
                                     np.array([self.member_id], dtype="int32"))

        ds = Dataset(data_vars=data_vars, coords=coords)
        sorted_dims = (("time", "ens", "lev", "lat", "lon")
                       if self.is_ensemble_member
                       else ("time", "lev", "lat", "lon"))
        ds = ds.reindex(lev=ds.coords["lev"].data[::-1]).transpose(*sorted_dims)
        return ds


def _decode_cf_time(values, units):
    """Decode 'X since YYYY-mm-dd...' numeric time to datetime64."""
    import re
    m = re.match(r"(\w+) since (\d{4}-\d{2}-\d{2})[ T]?(\d{2}:\d{2}:\d{2})?",
                 units)
    if not m:
        raise ValueError(f"Cannot parse time units: {units!r}")
    unit, date, time = m.groups()
    ref = np.datetime64(f"{date}T{time or '00:00:00'}")
    scale = {"days": "D", "hours": "h", "minutes": "m",
             "seconds": "s"}[unit]
    return ref + values.astype(f"timedelta64[{scale}]").astype(
        "timedelta64[s]")


class SpeedyEns:
    """Ensemble of Speedy instances (reference: pyspeedy/speedy.py:486-597).

    The batched execution path runs all members in one vmapped step
    (see parallel/ensemble.py); this class keeps the reference's per-member
    object API on top of it.
    """

    def __init__(self, num_of_members, start_date=datetime(1982, 1, 1),
                 end_date=datetime(1982, 1, 2), params: ModelParams = T30L8):
        self.n_members = num_of_members
        self.members = [
            Speedy(start_date=start_date, end_date=end_date, member=m,
                   params=params)
            for m in range(num_of_members)
        ]
        self.current_date = self.members[0].current_date

    def __iter__(self):
        return iter(self.members)

    def __len__(self):
        return self.n_members

    def set_params(self, start_date=datetime(1982, 1, 1),
                   end_date=datetime(1982, 1, 2)):
        for member in self:
            member.set_params(start_date=start_date, end_date=end_date)
        self.current_date = start_date

    @property
    def _dt_step(self):
        return self.members[0]._dt_step

    def to_dataframe(self, variables=None):
        return merge([m.to_dataframe(variables=variables) for m in self],
                     join="outer", compat="no_conflicts")

    def get_current_step(self):
        return self.members[0].get_current_step()

    def run(self, callbacks=None, batched=None):
        """Step all members in lockstep (the reference uses OpenMP threads,
        speedy_driver.f90:58-79).

        batched=True (default when all members share one configuration)
        advances every member with ONE vmapped jitted scan (the batched
        parallel_step). batched=False steps members sequentially."""
        if callbacks is None:
            callbacks = []

        end_date = self.members[0].end_date
        total = round((end_date - self.current_date) / self._dt_step)
        intervals = [cb.interval for cb in callbacks
                     if getattr(cb, "interval", None)]
        chunk = math.gcd(*intervals) if intervals else max(total, 1)

        if batched is None:
            batched = all(m._consts is self.members[0]._consts
                          for m in self.members)

        done = 0
        while done < total:
            n = min(chunk, total - done)
            if batched:
                self._advance_batched(n)
            else:
                for member in self:
                    member._advance(n)
            errors = {m: E_DIAGNOSTICS_OUTSIDE_RANGE
                      for m, member in enumerate(self)
                      if bool(member._state["error_flag"])}
            done += n
            self.current_date += self._dt_step * n
            for member in self:
                member.current_date = self.current_date
            if errors:
                msg = "".join(f"Member{m}: {ERROR_CODES[c]}\n"
                              for m, c in errors.items())
                raise RuntimeError(msg)
            for callback in callbacks:
                callback(self)

    def _advance_batched(self, n_steps):
        """Vmapped scans over all members (zero member communication),
        chunked along the member axis past the measured throughput knee
        (parallel/ensemble.py MEMBER_CHUNK)."""
        import jax.numpy as _jnp

        from .models.model import DYNAMIC_FIELDS, EPHEMERAL_FIELDS
        from .parallel.ensemble import (make_run_steps_batched,
                                        pick_member_chunk, pick_scan_unroll)

        lead = self.members[0]
        if not hasattr(self, "_batched_run"):
            self._batched_run = {}

        n = len(self.members)
        chunk = pick_member_chunk(n, lead.params)
        # The SW-aligned runner (physics on) handles any n_steps; the
        # unaligned group scan (physics off) needs whole triples.
        phase = (lead._current_step % 3) if (
            lead._consts.physics_on or n_steps % 3 == 0) else None
        key = (id(lead._consts), phase, chunk)
        if key not in self._batched_run:
            self._batched_run[key] = make_run_steps_batched(
                lead._consts, donate=False, phase=phase,
                unroll=pick_scan_unroll(chunk, lead.params))
        run = self._batched_run[key]

        import jax as _jax

        ctx, cal = M.build_step_ctx(lead._cal, lead._current_step, n_steps)
        for c0 in range(0, n, chunk):
            sub = self.members[c0:c0 + chunk]
            state = dict(sub[0]._state)
            for name in list(state.keys()):
                if name in DYNAMIC_FIELDS and name not in EPHEMERAL_FIELDS:
                    state[name] = _jax.tree.map(
                        lambda *leaves: _jnp.stack(leaves),
                        *[m._state[name] for m in sub])
            out = run(state, ctx)
            # With physics off the EPHEMERAL fields pass through the runner
            # at single-member shapes — indexing [m] there would slice a
            # non-member axis (latitude for hfluxn, which the coupler reads).
            batched = DYNAMIC_FIELDS if lead._consts.physics_on else (
                DYNAMIC_FIELDS - EPHEMERAL_FIELDS)
            for m, member in enumerate(sub):
                st = dict(member._state)
                for name in batched:
                    if name in out:
                        st[name] = _jax.tree.map(lambda a: a[m], out[name])
                member._state = st
                member._current_step += n_steps
                member._cal = dataclasses.replace(cal)
