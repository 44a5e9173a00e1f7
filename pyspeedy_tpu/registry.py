"""Model-state variable registry.

The single source of truth for the public state schema: variable names,
Fortran-order API shapes, units and NetCDF metadata — the
equivalent of the reference's registry/model_state_def.py (which generates
Fortran accessors; here the same facts drive a pytree state dict and the
xarray-style export metadata).

Each entry: (name, kind, dims, units, long_name, std_name, alt_name, nc_dims)
where dims is the Fortran-order dimension tuple using symbolic sizes resolved
against ModelParams, and kind is "c" (complex), "r" (real), "i" (int),
"l" (logical/bool).
"""

from __future__ import annotations

from typing import NamedTuple


class VarSpec(NamedTuple):
    name: str
    kind: str
    dims: tuple
    units: str | None
    long_name: str | None
    std_name: str | None
    alt_name: str | None
    nc_dims: tuple | None
    time_dim: str | None


_V = VarSpec

MODEL_STATE_VARS = [
    _V('current_step', 'i', (), None, 'Current model step.', 'current_step', 'current_step', None, None),
    _V('vor', 'c', ('mx', 'nx', 'kx', 't_levs'), None, 'Vorticity', 'vor', 'vor', ('mx', 'nx', 'lev', 't_levs'), None),
    _V('div', 'c', ('mx', 'nx', 'kx', 't_levs'), None, 'Divergence', 'div', 'div', ('mx', 'nx', 'lev', 't_levs'), None),
    _V('t', 'c', ('mx', 'nx', 'kx', 't_levs'), None, 'Temperature', 't', 't', ('mx', 'nx', 'lev', 't_levs'), None),
    _V('ps', 'c', ('mx', 'nx', 't_levs'), None, 'Log of (normalised) surface pressure', 'ps', 'ps', ('mx', 'nx', 't_levs'), None),
    _V('tr', 'c', ('mx', 'nx', 'kx', 't_levs', 'ntr'), None, 'Tracers (tr(1): specific humidity in g/kg)', 'tr', 'tr', ('mx', 'nx', 'lev', 't_levs', 'ntr'), None),
    _V('phi', 'c', ('mx', 'nx', 'kx'), 'm', 'Atmospheric geopotential', 'phi', 'phi', ('mx', 'nx', 'lev'), None),
    _V('phis', 'c', ('mx', 'nx'), None, 'Surface geopotential', 'phis', 'phis', ('mx', 'nx'), None),
    _V('u_grid', 'r', ('ix', 'il', 'kx'), 'm/s', 'eastward_wind', 'u_grid', 'u', ('lon', 'lat', 'lev'), None),
    _V('v_grid', 'r', ('ix', 'il', 'kx'), 'm/s', 'northward_wind', 'v_grid', 'v', ('lon', 'lat', 'lev'), None),
    _V('t_grid', 'r', ('ix', 'il', 'kx'), 'K', 'air_temperature', 't_grid', 't', ('lon', 'lat', 'lev'), None),
    _V('q_grid', 'r', ('ix', 'il', 'kx'), None, 'specific_humidity', 'q_grid', 'q', ('lon', 'lat', 'lev'), None),
    _V('phi_grid', 'r', ('ix', 'il', 'kx'), None, 'geopotential_height', 'phi_grid', 'phi', ('lon', 'lat', 'lev'), None),
    _V('ps_grid', 'r', ('ix', 'il'), None, 'surface_air_pressure', 'ps_grid', 'ps', ('lon', 'lat'), None),
    _V('precnv', 'r', ('ix', 'il'), None, 'Convective precipitation, total', 'precnv', 'precnv', ('lon', 'lat'), None),
    _V('precls', 'r', ('ix', 'il'), None, 'Large-scale precipitation, total', 'precls', 'precls', ('lon', 'lat'), None),
    _V('snowcv', 'r', ('ix', 'il'), None, 'Convective precipitation, snow only', 'snowcv', 'snowcv', ('lon', 'lat'), None),
    _V('snowls', 'r', ('ix', 'il'), None, 'Large-scale precipitation, snow only', 'snowls', 'snowls', ('lon', 'lat'), None),
    _V('cbmf', 'r', ('ix', 'il'), None, 'Cloud-base mass flux', 'cbmf', 'cbmf', ('lon', 'lat'), None),
    _V('tsr', 'r', ('ix', 'il'), None, 'Top-of-atmosphere shortwave radiation (downward)', 'tsr', 'tsr', ('lon', 'lat'), None),
    _V('ssrd', 'r', ('ix', 'il'), None, 'Surface shortwave radiation (downward-only)', 'ssrd', 'ssrd', ('lon', 'lat'), None),
    _V('ssr', 'r', ('ix', 'il'), None, 'Surface shortwave radiation (net downward)', 'ssr', 'ssr', ('lon', 'lat'), None),
    _V('slrd', 'r', ('ix', 'il'), None, 'Surface longwave radiation (downward-only)', 'slrd', 'slrd', ('lon', 'lat'), None),
    _V('slr', 'r', ('ix', 'il'), None, 'Surface longwave radiation (net upward)', 'slr', 'slr', ('lon', 'lat'), None),
    _V('olr', 'r', ('ix', 'il'), None, 'Outgoing longwave radiation (upward)', 'olr', 'olr', ('lon', 'lat'), None),
    _V('slru', 'r', ('ix', 'il', 'aux_dim'), None, 'Surface longwave emission (upward)', 'slru', 'slru', ('lon', 'lat', 'aux_dim'), None),
    _V('ustr', 'r', ('ix', 'il', 'aux_dim'), None, 'U-stress', 'ustr', 'ustr', ('lon', 'lat', 'aux_dim'), None),
    _V('vstr', 'r', ('ix', 'il', 'aux_dim'), None, 'Vstress', 'vstr', 'vstr', ('lon', 'lat', 'aux_dim'), None),
    _V('shf', 'r', ('ix', 'il', 'aux_dim'), None, 'Sensible heat flux', 'shf', 'shf', ('lon', 'lat', 'aux_dim'), None),
    _V('evap', 'r', ('ix', 'il', 'aux_dim'), None, 'Evaporation', 'evap', 'evap', ('lon', 'lat', 'aux_dim'), None),
    _V('hfluxn', 'r', ('ix', 'il', 'aux_dim'), None, 'Net heat flux into surface', 'hfluxn', 'hfluxn', ('lon', 'lat', 'aux_dim'), None),
    _V('tt_rsw', 'r', ('ix', 'il', 'kx'), None, 'Flux of short-wave radiation absorbed in each atmospheric layer', 'tt_rsw', 'tt_rsw', ('lon', 'lat', 'lev'), None),
    _V('phi0', 'r', ('ix', 'il'), None, 'Unfiltered surface geopotential', 'phi0', 'phi0', ('lon', 'lat'), None),
    _V('orog', 'r', ('ix', 'il'), None, 'Orography', 'orog', 'orog', ('lon', 'lat'), None),
    _V('phis0', 'r', ('ix', 'il'), None, 'Spectrally-filtered surface geopotential', 'phis0', 'phis0', ('lon', 'lat'), None),
    _V('alb0', 'r', ('ix', 'il'), None, 'Bare-land annual-mean albedo', 'alb0', 'alb0', ('lon', 'lat'), None),
    _V('forog', 'r', ('ix', 'il'), None, 'Orographic factor for land surface drag', 'forog', 'forog', ('lon', 'lat'), None),
    _V('fmask_orig', 'r', ('ix', 'il'), None, 'Original (fractional) land-sea mask', 'fmask_orig', 'fmask_orig', ('lon', 'lat'), None),
    _V('xgeop1', 'r', ('kx',), None, 'Constant 1 for hydrostatic equation', 'xgeop1', 'xgeop1', ('lev',), None),
    _V('xgeop2', 'r', ('kx',), None, 'Constant 2 for hydrostatic equation', 'xgeop2', 'xgeop2', ('lev',), None),
    _V('stl12', 'r', ('ix', 'il', '12'), None, 'Land surface temperature monthly-mean climatology', 'stl12', 'stl12', ('lon', 'lat', '12'), None),
    _V('snowd12', 'r', ('ix', 'il', '12'), None, 'Snow depth (water equivalent) monthly-mean climatology', 'snowd12', 'snowd12', ('lon', 'lat', '12'), None),
    _V('soilw12', 'r', ('ix', 'il', '12'), None, 'Soil water availability monthly-mean climatology', 'soilw12', 'soilw12', ('lon', 'lat', '12'), None),
    _V('veg_low', 'r', ('ix', 'il'), None, 'Low vegetation fraction', 'veg_low', 'veg_low', ('lon', 'lat'), None),
    _V('veg_high', 'r', ('ix', 'il'), None, 'High vegetation fraction', 'veg_high', 'veg_high', ('lon', 'lat'), None),
    _V('soil_wc_l1', 'r', ('ix', 'il', '12'), None, 'Soil water content: Layer 1', 'soil_wc_l1', 'soil_wc_l1', ('lon', 'lat', '12'), None),
    _V('soil_wc_l2', 'r', ('ix', 'il', '12'), None, 'Soil water content: Layer 2', 'soil_wc_l2', 'soil_wc_l2', ('lon', 'lat', '12'), None),
    _V('soil_wc_l3', 'r', ('ix', 'il', '12'), None, 'Soil water content: Layer 3', 'soil_wc_l3', 'soil_wc_l3', ('lon', 'lat', '12'), None),
    _V('sst12', 'r', ('ix', 'il', '12'), None, 'Sea/ice surface temperature', 'sst12', 'sst12', ('lon', 'lat', '12'), None),
    _V('sea_ice_frac12', 'r', ('ix', 'il', '12'), None, 'Sea ice fraction', 'sea_ice_frac12', 'sea_ice_frac12', ('lon', 'lat', '12'), None),
    _V('sst_anom', 'r', ('ix', 'il', '0:n_months+1'), None, 'Observed SST anomaly (input).', 'sst_anom', 'sst_anom', ('lon', 'lat', '0:n_months+1'), 'n_months'),
    _V('increase_co2', 'l', (), None, 'Flag for CO2 optical thickness increase', 'increase_co2', 'increase_co2', None, None),
    _V('compute_shortwave', 'l', (), None, 'Flag for shortwave radiation routine (turned on and off in main loop depending on the value of nstrad)', 'compute_shortwave', 'compute_shortwave', None, None),
    _V('air_absortivity_co2', 'r', (), None, 'Absorptivity of air in CO2 band', 'air_absortivity_co2', 'air_absortivity_co2', None, None),
    _V('flux_solar_in', 'r', ('ix', 'il'), None, 'Flux of incoming solar radiation', 'flux_solar_in', 'flux_solar_in', ('lon', 'lat'), None),
    _V('flux_ozone_lower', 'r', ('ix', 'il'), None, 'Flux absorbed by ozone (lower stratosphere)', 'flux_ozone_lower', 'flux_ozone_lower', ('lon', 'lat'), None),
    _V('flux_ozone_upper', 'r', ('ix', 'il'), None, 'Flux absorbed by ozone (upper stratosphere)', 'flux_ozone_upper', 'flux_ozone_upper', ('lon', 'lat'), None),
    _V('zenit_correction', 'r', ('ix', 'il'), None, 'Zenith angle correction to (downward) absorptivity', 'zenit_correction', 'zenit_correction', ('lon', 'lat'), None),
    _V('stratospheric_correction', 'r', ('ix', 'il'), None, 'Stratospheric correction for polar night', 'stratospheric_correction', 'stratospheric_correction', ('lon', 'lat'), None),
    _V('qcloud_equiv', 'r', ('ix', 'il'), None, 'Equivalent specific humidity of clouds', 'qcloud_equiv', 'qcloud_equiv', ('lon', 'lat'), None),
    _V('rhcapl', 'r', ('ix', 'il'), None, '1/heat capacity (land)', 'rhcapl', 'rhcapl', ('lon', 'lat'), None),
    _V('cdland', 'r', ('ix', 'il'), None, '1/dissipation time (land)', 'cdland', 'cdland', ('lon', 'lat'), None),
    _V('stlcl_obs', 'r', ('ix', 'il'), None, 'Climatological land surface temperature', 'stlcl_obs', 'stlcl_obs', ('lon', 'lat'), None),
    _V('snowdcl_obs', 'r', ('ix', 'il'), None, 'Climatological snow depth (water equivalent)', 'snowdcl_obs', 'snowdcl_obs', ('lon', 'lat'), None),
    _V('soilwcl_obs', 'r', ('ix', 'il'), None, 'Climatological soil water availability', 'soilwcl_obs', 'soilwcl_obs', ('lon', 'lat'), None),
    _V('land_temp', 'r', ('ix', 'il'), None, 'Land surface temperature', 'land_temp', 'land_temp', ('lon', 'lat'), None),
    _V('snow_depth', 'r', ('ix', 'il'), None, 'Snow depth (water equivalent)', 'snow_depth', 'snow_depth', ('lon', 'lat'), None),
    _V('soil_avail_water', 'r', ('ix', 'il'), None, 'Soil water availability', 'soil_avail_water', 'soil_avail_water', ('lon', 'lat'), None),
    _V('stl_lm', 'r', ('ix', 'il'), None, 'Land-model surface temperature', 'stl_lm', 'stl_lm', ('lon', 'lat'), None),
    _V('fmask_land', 'r', ('ix', 'il'), None, 'Fraction of land', 'fmask_land', 'fmask_land', ('lon', 'lat'), None),
    _V('bmask_land', 'r', ('ix', 'il'), None, 'Binary land mask', 'bmask_land', 'bmask_land', ('lon', 'lat'), None),
    _V('land_coupling_flag', 'l', (), None, 'Flag for land-coupling (0: off, 1: on)', 'land_coupling_flag', 'land_coupling_flag', None, None),
    _V('rhcaps', 'r', ('ix', 'il'), None, '1./heat_capacity (sea)', 'rhcaps', 'rhcaps', ('lon', 'lat'), None),
    _V('rhcapi', 'r', ('ix', 'il'), None, '1./heat_capacity (ice)', 'rhcapi', 'rhcapi', ('lon', 'lat'), None),
    _V('cdsea', 'r', ('ix', 'il'), None, '1./dissip_time (sea)', 'cdsea', 'cdsea', ('lon', 'lat'), None),
    _V('cdice', 'r', ('ix', 'il'), None, '1./dissip_time (ice)', 'cdice', 'cdice', ('lon', 'lat'), None),
    _V('fmask_sea', 'r', ('ix', 'il'), None, 'Fraction of sea', 'fmask_sea', 'fmask_sea', ('lon', 'lat'), None),
    _V('bmask_sea', 'r', ('ix', 'il'), None, 'Binary sea mask', 'bmask_sea', 'bmask_sea', ('lon', 'lat'), None),
    _V('deglat_s', 'r', ('il',), None, 'Grid latitudes', 'deglat_s', 'deglat_s', ('lat',), None),
    _V('hfseacl', 'r', ('ix', 'il'), None, 'Annual-mean heat flux into sea sfc.', 'hfseacl', 'hfseacl', ('lon', 'lat'), None),
    _V('sstom12', 'r', ('ix', 'il', '12'), None, 'Ocean model SST climatology', 'sstom12', 'sstom12', ('lon', 'lat', '12'), None),
    _V('sstcl_ob', 'r', ('ix', 'il'), None, 'Observed clim. SST', 'sstcl_ob', 'sstcl_ob', ('lon', 'lat'), None),
    _V('sicecl_ob', 'r', ('ix', 'il'), None, 'Clim. sea ice fraction', 'sicecl_ob', 'sicecl_ob', ('lon', 'lat'), None),
    _V('ticecl_ob', 'r', ('ix', 'il'), None, 'Clim. sea ice temperature', 'ticecl_ob', 'ticecl_ob', ('lon', 'lat'), None),
    _V('sstan_ob', 'r', ('ix', 'il'), None, 'Daily observed SST anomaly', 'sstan_ob', 'sstan_ob', ('lon', 'lat'), None),
    _V('sstcl_om', 'r', ('ix', 'il'), None, 'Ocean model clim. SST', 'sstcl_om', 'sstcl_om', ('lon', 'lat'), None),
    _V('sst_am', 'r', ('ix', 'il'), None, 'SST (full-field)', 'sst_am', 'sst_am', ('lon', 'lat'), None),
    _V('sstan_am', 'r', ('ix', 'il'), None, 'SST anomaly', 'sstan_am', 'sstan_am', ('lon', 'lat'), None),
    _V('sice_am', 'r', ('ix', 'il'), None, 'Sea ice fraction', 'sice_am', 'sice_am', ('lon', 'lat'), None),
    _V('tice_am', 'r', ('ix', 'il'), None, 'Sea ice temperature', 'tice_am', 'tice_am', ('lon', 'lat'), None),
    _V('sst_om', 'r', ('ix', 'il'), None, 'Ocean model SST', 'sst_om', 'sst_om', ('lon', 'lat'), None),
    _V('sice_om', 'r', ('ix', 'il'), None, 'Model sea ice fraction', 'sice_om', 'sice_om', ('lon', 'lat'), None),
    _V('tice_om', 'r', ('ix', 'il'), None, 'Model sea ice temperature', 'tice_om', 'tice_om', ('lon', 'lat'), None),
    _V('ssti_om', 'r', ('ix', 'il'), None, 'Model SST + sea ice temp.', 'ssti_om', 'ssti_om', ('lon', 'lat'), None),
    _V('wsst_ob', 'r', ('ix', 'il'), None, 'Weight for obs. SST anomaly in coupled runs', 'wsst_ob', 'wsst_ob', ('lon', 'lat'), None),
    _V('sst_anomaly_coupling_flag', 'l', (), None, 'Weight for obs. SST anomaly in coupled runs', 'sst_anomaly_coupling_flag', 'sst_anomaly_coupling_flag', None, None),
    _V('ablco2_ref', 'r', (), None, 'Initial absorptivity of air in CO2 band (t=t0)', 'ablco2_ref', 'ablco2_ref', None, None),
    _V('fband', 'r', ('100:400', '4'), None, 'Energy fraction emitted in each LW band = f(T)', 'fband', 'fband', ('100:400', '4'), None),
    _V('alb_land', 'r', ('ix', 'il'), None, 'Daily-mean albedo over land (bare-land + snow)', 'alb_land', 'alb_land', ('lon', 'lat'), None),
    _V('alb_sea', 'r', ('ix', 'il'), None, 'Daily-mean albedo over sea  (open sea + sea ice)', 'alb_sea', 'alb_sea', ('lon', 'lat'), None),
    _V('alb_surface', 'r', ('ix', 'il'), None, 'Combined surface albedo (land + sea)', 'alb_surface', 'alb_surface', ('lon', 'lat'), None),
    _V('snowc', 'r', ('ix', 'il'), None, 'Effective snow cover (fraction)', 'snowc', 'snowc', ('lon', 'lat'), None),
    _V('rad_flux', 'r', ('ix', 'il', '4'), None, 'Radiative flux in different spectral bands', 'rad_flux', 'rad_flux', ('lon', 'lat', '4'), None),
    _V('rad_tau2', 'r', ('ix', 'il', 'kx', '4'), None, 'Transmissivity of atmospheric layers', 'rad_tau2', 'rad_tau2', ('lon', 'lat', 'lev', '4'), None),
    _V('rad_st4a', 'r', ('ix', 'il', 'kx', '2'), None, 'Blackbody emission from full and half atmospheric levels', 'rad_st4a', 'rad_st4a', ('lon', 'lat', 'lev', '2'), None),
    _V('rad_strat_corr', 'r', ('ix', 'il', '2'), None, 'Stratospheric correction term', 'rad_strat_corr', 'rad_strat_corr', ('lon', 'lat', '2'), None),
    _V('lon', 'r', ('ix',), 'degrees_east', 'longitude', 'lon', 'lon', ('lon',), None),
    _V('lat', 'r', ('il',), 'degrees_north', 'latitude', 'lat', 'lat', ('lat',), None),
    _V('lev', 'r', ('kx',), None, 'Vertical sigma coordinate', 'lev', 'lev', ('lev',), None),
]

REGISTRY = {v.name: v for v in MODEL_STATE_VARS}


def resolve_dims(params, dims, n_months=None):
    """Resolve symbolic Fortran-order dims to concrete sizes."""
    out = []
    for dname in dims:
        if dname == "mx":
            out.append(params.mx)
        elif dname == "nx":
            out.append(params.nx)
        elif dname == "kx":
            out.append(params.kx)
        elif dname == "ix":
            out.append(params.ix)
        elif dname == "il":
            out.append(params.il)
        elif dname == "iy":
            out.append(params.iy)
        elif dname == "t_levs":
            out.append(params.t_levs)
        elif dname == "ntr":
            out.append(params.ntr)
        elif dname == "aux_dim":
            out.append(params.aux_dim)
        elif dname == "12":
            out.append(12)
        elif dname == "4":
            out.append(4)
        elif dname == "2":
            out.append(2)
        elif dname == "100:400":
            out.append(301)
        elif dname == "0:n_months+1":
            if n_months is None:
                raise ValueError("sst_anom shape requires n_months")
            out.append(n_months + 2)
        else:
            raise KeyError(f"unknown dim symbol {dname!r}")
    return tuple(out)


# ---------------------------------------------------------------------------
# Internal array layouts
# ---------------------------------------------------------------------------
# API arrays use the reference's Fortran-order shapes (e.g. vor is
# (mx, nx, kx, t_levs)). Internally, batch-like axes lead and the spectral
# (mx, nx) pair stays innermost: vor is stored (t_levs, kx, mx, nx), grid
# fields (kx, il, ix), etc. The permutation below maps API axes -> internal
# axis order.

def internal_perm(spec: VarSpec):
    """Permutation p such that internal = api.transpose(p); None for 0-d.

    Variables with a t_levs axis always put it FIRST internally: at runtime
    the two leapfrog time levels are held as a Python TUPLE of per-level
    arrays (a pytree, so time-level selection is free at trace time instead
    of a per-step strided slice + re-stack of the scan carry). The stacked
    array
    view (= np.stack(tuple, 0)) is only materialized at the API boundary.
    """
    dims = spec.dims
    if not dims:
        return None
    if spec.name == "fband":
        return tuple(range(len(dims)))  # stored (301, 4) as in the API
    tl = (dims.index("t_levs"),) if "t_levs" in dims else ()
    if "mx" in dims:
        im, inn = dims.index("mx"), dims.index("nx")
        others = [i for i in range(len(dims))
                  if i not in (im, inn) and i not in tl]
        return tl + tuple(reversed(others)) + (im, inn)
    others = [i for i in range(len(dims)) if i not in tl]
    return tl + tuple(reversed(others))


def is_tlev(spec: VarSpec) -> bool:
    """True when the variable carries the leapfrog t_levs axis (held as a
    tuple of per-level arrays internally)."""
    return bool(spec.dims) and "t_levs" in spec.dims


def internal_shape(params, spec: VarSpec, n_months=None):
    api = resolve_dims(params, spec.dims, n_months)
    perm = internal_perm(spec)
    if perm is None:
        return ()
    return tuple(api[i] for i in perm)


def to_api_array(spec: VarSpec, arr):
    """Internal layout (tuple-of-levels for t_levs vars; real (2, ...) pairs
    for complex-kind vars — see ops/spectral.py) -> Fortran-order complex/real
    API layout."""
    import numpy as _np

    def _complexify(a):
        a = _np.asarray(a)
        return a[0] + 1j * a[1]

    if isinstance(arr, (tuple, list)):
        levels = [_complexify(a) if spec.kind == "c" else _np.asarray(a)
                  for a in arr]
        arr = _np.stack(levels, axis=0)
    elif spec.kind == "c":
        arr = _complexify(arr)
    perm = internal_perm(spec)
    if perm is None or list(perm) == sorted(perm):
        return arr
    inv = _np.argsort(_np.asarray(perm))
    return arr.transpose(tuple(inv))


def from_api_array(spec: VarSpec, arr):
    """Fortran-order API layout -> internal layout (tuple-of-levels for
    t_levs vars; real (2, ...) pairs for complex-kind vars)."""
    import numpy as _np

    def _pairify(a):
        a = _np.asarray(a)
        return _np.stack([a.real, a.imag], axis=0)

    perm = internal_perm(spec)
    if perm is not None and list(perm) != sorted(perm):
        arr = arr.transpose(perm)
    if is_tlev(spec):
        levels = tuple(arr[i] for i in range(arr.shape[0]))
        if spec.kind == "c":
            levels = tuple(_pairify(a) for a in levels)
        return levels
    if spec.kind == "c":
        return _pairify(arr)
    return arr
